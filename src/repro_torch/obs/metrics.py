"""Metrics registry: labeled Counters, Gauges, log2-bucket Histograms, and
bounded Series, plus the ONE shared arrive-step windowing implementation.

HGum's pitch is schema-driven correctness *and* hardware-quality
performance — but a claim like that is only checkable against live
numbers.  This module is the host-side half of the telemetry plane
(``repro.obs``): every subsystem (fabric ticks, the continuous batcher,
stream lanes, the serve loop) registers its observables here, and one
``snapshot()`` turns the whole registry into a JSON-ready dict that
``obs.report`` renders and ``python -m repro.obs`` summarizes.

Metric types
------------
* :class:`Counter` — monotonically increasing event count (``add``).
* :class:`Gauge`   — last-write-wins instantaneous value (``set``).
* :class:`Histogram` — fixed log2 buckets (upper bounds ``base * 2**i``),
  so the snapshot is a constant-size vector no matter how many samples
  land in it; tracks count/sum/min/max alongside the buckets.
* :class:`Series`  — a bounded append-only trace (e.g. per-tick
  backpressure p95 values) for observables whose *trajectory* matters.

Every metric is keyed by ``(name, sorted labels)``; asking for the same
key returns the same instance, so call sites never coordinate.

Shared windowing (the ``arrive_steps`` dedupe)
----------------------------------------------
``Fabric.class_arrive_stats`` and ``StreamReader.class_arrive_stats``
both used to hand-roll deque windows over router arrive steps.  The
window math now lives HERE — :func:`window_stats` (the percentile
definition both ends of the backpressure feedback loop must agree on)
and :class:`ClassWindows` (per-class bounded traces) — and both call it,
so the stats are byte-identical by construction.

``p95`` is nearest-rank with a CEIL rank (``ceil(0.95 * n)``): the
smallest value with >= 95% of the trace at or below it.  (A floor index
is biased one rank high — at n=20 it reports the maximum as "p95",
inflating the very tail signal the lane scheduler clamps on.)
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

#: bump when the snapshot layout changes (readers ignore unknown keys, so
#: additions are forward-compatible without a bump)
SNAPSHOT_SCHEMA = 1


def window_stats(steps: Iterable[float]) -> Dict[str, float]:
    """Latency statistics over a trace of router arrive steps (or any
    latency samples): ``mean`` tracks hop count + queueing, ``p50``/
    ``p95``/``max`` expose the tail a far-shard or starved tenant
    produces, and ``jitter`` is the stddev — the time-to-token wobble the
    shortest-path router shrinks.  Shared by
    ``StreamReader.class_arrive_stats``, ``Fabric.class_arrive_stats``,
    and the benchmarks so the producers and consumers of the backpressure
    feedback loop can never disagree on what "p95" means."""
    arr = sorted(steps)
    if not arr:
        return {"n": 0, "mean": 0.0, "p95": 0.0, "max": 0.0, "jitter": 0.0}
    n = len(arr)
    mean = sum(arr) / n
    var = sum((s - mean) ** 2 for s in arr) / n
    return {
        "n": n,
        "mean": mean,
        "p95": float(arr[min(n - 1, math.ceil(0.95 * n) - 1)]),
        "max": float(arr[-1]),
        "jitter": var ** 0.5,
    }


def quantile_from_buckets(
    base: float, buckets: List[int], count: int,
    vmin: Optional[float], vmax: Optional[float], q: float,
) -> Optional[float]:
    """Quantile estimate over a log2-bucket vector with within-bucket
    linear interpolation — the shared math behind
    :meth:`Histogram.quantile` and ``obs.report``'s snapshot diffs.

    The CEIL rank convention matches :func:`window_stats` (the smallest
    value with ``>= q`` of the mass at or below it); the hit bucket's
    span ``(lo, hi]`` is interpolated by the rank's position inside the
    bucket and the result is clamped to the exact observed ``[min,
    max]`` (so a one-sample histogram reports that sample, not a bucket
    edge).  Returns None on an empty histogram."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    if count <= 0:
        return None
    rank = q * count
    cum = 0
    for i, c in enumerate(buckets):
        if c > 0 and cum + c >= rank:
            lo = 0.0 if i == 0 else base * (1 << (i - 1))
            hi = base * (1 << i)
            if i == len(buckets) - 1 and vmax is not None:
                hi = max(vmax, lo)  # overflow bucket: cap at observed max
            frac = min(1.0, max(0.0, (rank - cum) / c))
            v = lo + frac * (hi - lo)
            if vmin is not None:
                v = max(v, vmin)
            if vmax is not None:
                v = min(v, vmax)
            return v
        cum += c
    return vmax


class ClassWindows:
    """Per-class bounded traces of latency samples with shared stats.

    The one implementation of the "deque window per QoS class" pattern:
    ``record(cls, value)`` appends into a ``maxlen``-bounded deque and
    ``stats()`` runs :func:`window_stats` per class.  ``stats(window=k)``
    restricts each class to its most recent ``k`` samples so a clamped
    tenant can *recover* once its congested tail drains instead of being
    haunted by old congestion forever."""

    def __init__(self, maxlen: int = 256):
        self.maxlen = maxlen
        self._traces: Dict[int, Deque[float]] = {}

    def record(self, cls: int, value: float) -> None:
        self._traces.setdefault(cls, deque(maxlen=self.maxlen)).append(value)

    def trace(self, cls: int) -> List[float]:
        return list(self._traces.get(cls, ()))

    def stats(self, window: Optional[int] = None) -> Dict[int, Dict[str, float]]:
        return {
            cls: window_stats(list(tr)[-window:] if window else tr)
            for cls, tr in sorted(self._traces.items())
        }


# ---------------------------------------------------------------------------
# metric instances
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic event counter."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0

    def add(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n

    def _snap(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def _snap(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed log2-bucket histogram: bucket ``i`` counts samples with
    ``value <= base * 2**i`` (the last bucket is the +inf overflow), so
    the snapshot stays constant-size regardless of sample volume.  The
    bucketed view costs resolution; ``count``/``sum``/``min``/``max``
    ride alongside exactly."""

    kind = "histogram"

    def __init__(self, base: float = 1.0, n_buckets: int = 24) -> None:
        if base <= 0 or n_buckets < 2:
            raise ValueError(f"bad histogram shape base={base} n={n_buckets}")
        self.base = base
        self.buckets = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        if v <= self.base:
            i = 0
        else:
            i = min(len(self.buckets) - 1,
                    int(math.ceil(math.log2(v / self.base))))
        self.buckets[i] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def bounds(self) -> List[float]:
        """Upper bound of each bucket (the last is open / +inf)."""
        return [self.base * (1 << i) for i in range(len(self.buckets))]

    def quantile(self, q: float) -> Optional[float]:
        """Quantile estimate with within-bucket linear interpolation,
        clamped to the exact observed [min, max] (see
        :func:`quantile_from_buckets`).  None when empty."""
        return quantile_from_buckets(
            self.base, self.buckets, self.count, self.min, self.max, q
        )

    def _snap(self) -> dict:
        return {
            "base": self.base, "buckets": list(self.buckets),
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
        }


class Series:
    """Bounded append-only value trace (per-tick trajectories)."""

    kind = "series"

    def __init__(self, maxlen: int = 4096) -> None:
        self.values: Deque[float] = deque(maxlen=maxlen)

    def append(self, v: float) -> None:
        self.values.append(float(v))

    def _snap(self) -> dict:
        return {"values": [float(v) for v in self.values]}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_key(name: str, labels: Dict[str, object]) -> str:
    """Canonical flat key: ``name{a=1,b=x}`` (labels sorted), ``name``
    when unlabeled — what reports and tests address metrics by."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in _label_key(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Process-local registry of labeled metrics.

    ``counter/gauge/histogram/series(name, **labels)`` get-or-create the
    instance for that (name, labels) key.  A name is pinned to ONE metric
    type at first use — re-registering it as another type raises, so two
    subsystems cannot silently fight over a name."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, cls, name: str, labels: Dict[str, object], **kw):
        kind = self._kinds.setdefault(name, cls.kind)
        if kind != cls.kind:
            raise ValueError(
                f"metric {name!r} already registered as a {kind}, "
                f"cannot re-register as a {cls.kind}"
            )
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(**kw)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, base: float = 1.0, n_buckets: int = 24,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, base=base,
                         n_buckets=n_buckets)

    def series(self, name: str, maxlen: int = 4096, **labels) -> Series:
        return self._get(Series, name, labels, maxlen=maxlen)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The whole registry as a JSON-ready dict (stable ordering):
        ``{"schema": 1, "metrics": [{"name", "type", "labels", ...}]}``.
        Readers MUST ignore unknown keys — that is the forward-compat
        contract the bench perf gate and CI schema checks rely on."""
        rows = []
        for (name, labels), m in sorted(
            self._metrics.items(), key=lambda kv: (kv[0][0], kv[0][1])
        ):
            row = {"name": name, "type": m.kind, "labels": dict(labels)}
            row.update(m._snap())
            rows.append(row)
        return {"schema": SNAPSHOT_SCHEMA, "metrics": rows}

    def flat(self) -> Dict[str, object]:
        """``{format_key(...): value}`` view — counters/gauges map to
        their value, histograms to ``{count, sum, min, max}``, series to
        the value list.  The convenient form for asserts and reports."""
        out: Dict[str, object] = {}
        for (name, labels), m in self._metrics.items():
            key = format_key(name, dict(labels))
            if isinstance(m, (Counter, Gauge)):
                out[key] = m.value
            elif isinstance(m, Histogram):
                out[key] = {"count": m.count, "sum": m.sum,
                            "min": m.min, "max": m.max}
            else:
                out[key] = [float(v) for v in m.values]
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)


def validate_snapshot(snap: dict) -> List[str]:
    """Schema check of a metrics snapshot (the CI artifact gate): returns
    a list of problems, empty when the snapshot is well-formed.  Unknown
    top-level or per-metric keys are NOT problems (forward-compat)."""
    errs: List[str] = []
    if not isinstance(snap, dict):
        return [f"snapshot must be a dict, got {type(snap).__name__}"]
    if not isinstance(snap.get("schema"), int):
        errs.append("missing/invalid 'schema' (int) field")
    rows = snap.get("metrics")
    if not isinstance(rows, list):
        return errs + ["missing/invalid 'metrics' (list) field"]
    for i, row in enumerate(rows):
        where = f"metrics[{i}]"
        if not isinstance(row, dict):
            errs.append(f"{where}: not a dict")
            continue
        name, typ = row.get("name"), row.get("type")
        if not isinstance(name, str) or not name:
            errs.append(f"{where}: missing metric name")
        if typ not in ("counter", "gauge", "histogram", "series"):
            errs.append(f"{where} ({name}): unknown type {typ!r}")
            continue
        if not isinstance(row.get("labels", {}), dict):
            errs.append(f"{where} ({name}): labels must be a dict")
        if typ in ("counter", "gauge") and not isinstance(
            row.get("value"), (int, float)
        ):
            errs.append(f"{where} ({name}): missing numeric value")
        if typ == "histogram":
            if not isinstance(row.get("buckets"), list):
                errs.append(f"{where} ({name}): missing bucket list")
            elif row.get("count") != sum(row["buckets"]):
                errs.append(f"{where} ({name}): count != sum(buckets)")
        if typ == "series" and not isinstance(row.get("values"), list):
            errs.append(f"{where} ({name}): missing values list")
    return errs
