"""SLO declaration + evaluation over metrics snapshots.

The perf gate (``benchmarks.run``) compares wall-clock ratios; this
module gates on *service* objectives: declared latency/throughput/
integrity targets evaluated against a metrics snapshot (or a live
registry), each with a **burn rate** — observed / target for upper
bounds, target / observed for lower bounds — so "how close to the
budget" is a number, not a boolean.  ``python -m repro_torch.obs slo`` and the
``--slo`` flags on the serve and bench CLIs run exactly this evaluator,
so CI can fail on budget violations.

Spec forms (``parse_slo``)::

    ttft_p95_s=0.5,arrive_p95_steps=12,drift_free     # inline text
    slo.json                                          # {"ttft_p95_s": 0.5, ...}

Built-in objectives:

* ``ttft_p95_s`` / ``ttft_p99_s`` / ``ttft_mean_s`` — first-token
  latency over the ``serve.ttft_s.series`` trace (windowed; falls back
  to the ``serve.ttft_s`` histogram quantile with within-bucket
  interpolation).
* ``arrive_p95_steps`` — router arrive-step p95 over the merged
  ``fabric.arrive.step`` class histograms (the fabric-side latency SLO).
* ``tokens_per_s_min`` — decode throughput lower bound
  (``serve.tokens_per_s`` gauge).
* ``drift_free`` — zero static-vs-observed load drift entries
  (``fabric.load_drift.entries`` gauge): every frame rode the link the
  analyzer predicted.
* ``max_retransmit_ratio`` — ARQ recovery overhead upper bound:
  ``fabric.arq.retransmits / max(1, fabric.frames.delivered)`` (both
  counted in frames).  A zero-fault ARQ run measures 0.0; the delivered
  counter must be present (an ARQ SLO over a run that never delivered a
  frame fails as unobservable).
* ``max:<flat-key>`` / ``min:<flat-key>`` — generic bound on any
  counter/gauge by its ``format_key`` name (also matches plain numeric
  dicts, e.g. bench ``LAST_METRICS``), so new metrics are gateable
  without touching this module.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .metrics import format_key, quantile_from_buckets

_BUILTIN = (
    "ttft_p95_s", "ttft_p99_s", "ttft_mean_s", "arrive_p95_steps",
    "tokens_per_s_min", "drift_free", "max_retransmit_ratio",
)


def parse_slo(spec) -> Dict[str, object]:
    """Parse an SLO spec: a dict (returned as-is), a path to a JSON file,
    or ``k=v,k=v`` inline text (a bare key means True)."""
    if isinstance(spec, dict):
        return dict(spec)
    text = str(spec).strip()
    if os.path.exists(text) or text.endswith(".json"):
        with open(text) as f:
            obj = json.load(f)
        if not isinstance(obj, dict):
            raise ValueError(f"SLO file {text} must hold a JSON object")
        return obj
    out: Dict[str, object] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            try:
                out[k.strip()] = float(v)
            except ValueError:
                out[k.strip()] = v.strip()
        else:
            out[part] = True
    if not out:
        raise ValueError(f"empty SLO spec: {spec!r}")
    return out


@dataclass
class SLOResult:
    """One evaluated objective."""

    name: str
    target: object
    observed: Optional[float]
    ok: bool
    #: budget consumption: >= 1.0 means violated, None when unobservable
    burn_rate: Optional[float] = None
    detail: str = ""


@dataclass
class SLOReport:
    results: List[SLOResult] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def violations(self) -> List[SLOResult]:
        return [r for r in self.results if not r.ok]

    def render_text(self) -> str:
        lines = ["slo evaluation:"]
        for r in self.results:
            mark = "PASS" if r.ok else "FAIL"
            obs = "n/a" if r.observed is None else f"{r.observed:.6g}"
            burn = "" if r.burn_rate is None else f"  burn={r.burn_rate:.2f}"
            det = f"  ({r.detail})" if r.detail else ""
            lines.append(
                f"  [{mark}] {r.name}: observed {obs} vs target "
                f"{r.target}{burn}{det}"
            )
        lines.append(
            "slo: " + ("all objectives met"
                       if self.ok else
                       f"{len(self.violations())} objective(s) VIOLATED")
        )
        return "\n".join(lines)


# -- snapshot access helpers -------------------------------------------------


def _rows(snapshot: dict, name: str) -> List[dict]:
    return [r for r in snapshot.get("metrics", ())
            if isinstance(r, dict) and r.get("name") == name]


def _series_values(snapshot: dict, name: str,
                   window: Optional[int]) -> List[float]:
    vals: List[float] = []
    for r in _rows(snapshot, name):
        if r.get("type") == "series":
            vals.extend(float(v) for v in r.get("values", ()))
    return vals[-window:] if window else vals


def _merged_hist_quantile(snapshot: dict, name: str,
                          q: float) -> Optional[float]:
    """Quantile over every labeled variant of a histogram merged into one
    bucket vector (requires — and asserts — a shared base)."""
    rows = [r for r in _rows(snapshot, name) if r.get("type") == "histogram"]
    if not rows:
        return None
    base = rows[0].get("base", 1.0)
    n = max(len(r.get("buckets", ())) for r in rows)
    buckets = [0] * n
    count, vmin, vmax = 0, None, None
    for r in rows:
        if r.get("base", 1.0) != base:
            raise ValueError(f"histogram {name}: mixed bucket bases")
        for i, c in enumerate(r.get("buckets", ())):
            buckets[i] += int(c)
        count += int(r.get("count", 0))
        for bound, pick in (("min", min), ("max", max)):
            v = r.get(bound)
            if v is not None:
                cur = vmin if bound == "min" else vmax
                picked = v if cur is None else pick(cur, v)
                if bound == "min":
                    vmin = picked
                else:
                    vmax = picked
    return quantile_from_buckets(base, buckets, count, vmin, vmax, q)


def _flat_value(snapshot: dict, values: Optional[Dict[str, object]],
                key: str) -> Optional[float]:
    """Look a flat key up in the plain values dict first (bench
    LAST_METRICS), then among the snapshot's counters/gauges by
    ``format_key``."""
    if values is not None and key in values:
        v = values[key]
        return float(v) if isinstance(v, (int, float)) else None
    for r in snapshot.get("metrics", ()):
        if not isinstance(r, dict) or r.get("type") not in ("counter", "gauge"):
            continue
        if format_key(r.get("name", ""), r.get("labels", {})) == key:
            return float(r.get("value", 0))
    return None


def _ttft(snapshot: dict, q: Optional[float],
          window: Optional[int]) -> Optional[float]:
    vals = _series_values(snapshot, "serve.ttft_s.series", window)
    if vals:
        if q is None:
            return sum(vals) / len(vals)
        arr = sorted(vals)
        import math
        return float(arr[min(len(arr) - 1,
                             max(0, math.ceil(q * len(arr)) - 1))])
    if q is None:
        rows = [r for r in _rows(snapshot, "serve.ttft_s")
                if r.get("type") == "histogram"]
        count = sum(int(r.get("count", 0)) for r in rows)
        total = sum(float(r.get("sum", 0.0)) for r in rows)
        return total / count if count else None
    return _merged_hist_quantile(snapshot, "serve.ttft_s", q)


# -- the evaluator -----------------------------------------------------------


def evaluate_slo(
    spec,
    snapshot: Optional[dict] = None,
    values: Optional[Dict[str, object]] = None,
    window: Optional[int] = None,
) -> SLOReport:
    """Evaluate a parsed (or parseable) SLO spec against a metrics
    snapshot and/or a plain ``{flat_key: number}`` values dict.  Every
    objective yields an :class:`SLOResult`; an objective whose signal is
    absent FAILS (detail says so) — an SLO that silently passes because
    nothing was measured is worse than no SLO."""
    spec = parse_slo(spec)
    snapshot = snapshot or {"metrics": []}
    rep = SLOReport()

    def upper(name, target, observed, detail=""):
        t = float(target)
        if observed is None:
            rep.results.append(SLOResult(
                name, t, None, False, None,
                detail or "signal absent from snapshot"))
        else:
            burn = observed / t if t > 0 else float("inf")
            rep.results.append(SLOResult(
                name, t, float(observed), observed <= t, burn, detail))

    def lower(name, target, observed, detail=""):
        t = float(target)
        if observed is None:
            rep.results.append(SLOResult(
                name, t, None, False, None,
                detail or "signal absent from snapshot"))
        else:
            burn = t / observed if observed > 0 else float("inf")
            rep.results.append(SLOResult(
                name, t, float(observed), observed >= t, burn, detail))

    for name, target in spec.items():
        if name == "ttft_p95_s":
            upper(name, target, _ttft(snapshot, 0.95, window))
        elif name == "ttft_p99_s":
            upper(name, target, _ttft(snapshot, 0.99, window))
        elif name == "ttft_mean_s":
            upper(name, target, _ttft(snapshot, None, window))
        elif name == "arrive_p95_steps":
            upper(name, target,
                  _merged_hist_quantile(snapshot, "fabric.arrive.step", 0.95))
        elif name == "tokens_per_s_min":
            lower(name, target,
                  _flat_value(snapshot, values, "serve.tokens_per_s"))
        elif name == "drift_free":
            if not target:  # drift_free=false: explicitly waived
                continue
            drift = _flat_value(snapshot, values, "fabric.load_drift.entries")
            if drift is None:
                rep.results.append(SLOResult(
                    name, 0, None, False, None,
                    "fabric.load_drift.entries absent from snapshot"))
            else:
                rep.results.append(SLOResult(
                    name, 0, drift, drift == 0,
                    None if drift == 0 else float("inf"),
                    "static-vs-observed link-load drift entries"))
        elif name == "max_retransmit_ratio":
            retx = _flat_value(snapshot, values, "fabric.arq.retransmits")
            delivered = _flat_value(snapshot, values,
                                    "fabric.frames.delivered")
            ratio = (None if retx is None or delivered is None
                     else retx / max(1.0, delivered))
            upper(name, target, ratio,
                  detail=("fabric.arq.retransmits / fabric.frames.delivered "
                          "absent from snapshot — not an ARQ run?"
                          if ratio is None else
                          f"retransmits={retx:.0f} delivered={delivered:.0f}"))
        elif name.startswith("max:"):
            upper(name, target, _flat_value(snapshot, values, name[4:]))
        elif name.startswith("min:"):
            lower(name, target, _flat_value(snapshot, values, name[4:]))
        else:
            rep.results.append(SLOResult(
                name, target, None, False, None,
                f"unknown objective (builtins: {', '.join(_BUILTIN)}; "
                f"or max:<key> / min:<key>)"))
    return rep
