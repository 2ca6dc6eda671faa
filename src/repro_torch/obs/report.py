"""Render metrics snapshots + shared environment metadata.

Counterpart of the reference's ``obs/report.py``: the renderers, the
snapshot diff and the attribution tables are the reference's code;
:func:`environment_meta` reports torch, CUDA and the card in place of the
JAX backend.

``render_text`` turns a :func:`repro_torch.obs.metrics.MetricsRegistry.snapshot`
dict into a human-readable report (one line per counter/gauge, a bucket
sketch per histogram, tail stats per series); ``render_json`` is the
machine form.  Both read metrics by ``name``/``type`` and ignore unknown
keys, per the snapshot forward-compat contract.

:func:`environment_meta` is the ONE place run provenance is assembled —
the ``meta`` block in ``BENCH_*.json`` smoke snapshots, serve
``--metrics-json`` exports, and CI artifacts all embed it, so a perf-gate
comparison across machines can tell "regression" from "different
hardware"."""
from __future__ import annotations

import datetime
import json
import subprocess
from typing import Dict, List, Optional

from .metrics import (
    SNAPSHOT_SCHEMA,
    format_key,
    quantile_from_buckets,
    validate_snapshot,
)

__all__ = [
    "environment_meta", "render_text", "render_json",
    "diff_snapshots", "render_diff",
    "attribution_rows", "render_attribution",
]


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def environment_meta() -> dict:
    """Run provenance: schema version, torch/CUDA/device identity, git sha
    (None outside a checkout), and a UTC timestamp.  Readers treat every
    field as optional.

    ``backend`` is ``"cuda"`` when a card is visible and ``"cpu"``
    otherwise; ``platform`` is ``"gpu"`` or ``"cpu"`` to match; the device
    fields name card 0 (``torch.cuda.get_device_name``) and count the
    visible cards.  On the CPU ``device_kind`` is ``"cpu"`` and
    ``n_devices`` is 1.  There is no ``jax_version``: the port runs without
    JAX."""
    import torch

    meta = {
        "schema_version": SNAPSHOT_SCHEMA,
        "timestamp": datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    if torch.cuda.is_available():
        meta.update({
            "backend": "cuda",
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(0),
            "n_devices": torch.cuda.device_count(),
        })
    else:
        meta.update({"backend": "cpu", "platform": "cpu",
                     "device_kind": "cpu", "n_devices": 1})
    return meta


def _hist_sketch(row: dict, width: int = 20) -> str:
    buckets = row.get("buckets") or []
    peak = max(buckets) if buckets else 0
    if not peak:
        return "(empty)"
    base = row.get("base", 1.0)
    parts = []
    for i, c in enumerate(buckets):
        if c:
            parts.append(f"<={base * (1 << i):g}:{c}")
    return " ".join(parts)


def render_text(snap: dict) -> str:
    """Human-readable report of a metrics snapshot."""
    lines: List[str] = [f"metrics snapshot (schema {snap.get('schema')})"]
    problems = validate_snapshot(snap)
    for p in problems:
        lines.append(f"  !! {p}")
    by_type = {"counter": [], "gauge": [], "histogram": [], "series": []}
    for row in snap.get("metrics", []):
        if isinstance(row, dict) and row.get("type") in by_type:
            by_type[row["type"]].append(row)
    for typ in ("counter", "gauge", "histogram", "series"):
        rows = by_type[typ]
        if not rows:
            continue
        lines.append(f"{typ}s ({len(rows)}):")
        for row in rows:
            key = format_key(row.get("name", "?"), row.get("labels") or {})
            if typ in ("counter", "gauge"):
                v = row.get("value")
                v = f"{v:g}" if isinstance(v, float) else str(v)
                lines.append(f"  {key} = {v}")
            elif typ == "histogram":
                lines.append(
                    f"  {key}: n={row.get('count')} sum={row.get('sum'):g}"
                    f" min={row.get('min')} max={row.get('max')}"
                    f"  [{_hist_sketch(row)}]"
                )
            else:
                vals = row.get("values") or []
                tail = ", ".join(f"{v:g}" for v in vals[-6:])
                lines.append(
                    f"  {key}: n={len(vals)} last=[{tail}]"
                )
    if len(lines) == 1:
        lines.append("  (no metrics)")
    return "\n".join(lines)


def render_json(snap: dict, meta: bool = True, **kw) -> str:
    """Machine form: the snapshot itself, optionally wrapped with
    :func:`environment_meta` provenance under ``meta``."""
    out = dict(snap)
    if meta:
        out["meta"] = environment_meta()
    return json.dumps(out, **kw)


# ---------------------------------------------------------------------------
# snapshot diff (the perf-gate debugging tool)
# ---------------------------------------------------------------------------


def _by_key(snap: dict) -> Dict[str, dict]:
    out = {}
    for row in snap.get("metrics", []):
        if isinstance(row, dict) and row.get("name"):
            out[format_key(row["name"], row.get("labels") or {})] = row
    return out


def _row_summary(row: dict) -> object:
    typ = row.get("type")
    if typ in ("counter", "gauge"):
        return row.get("value")
    if typ == "histogram":
        return {
            "count": row.get("count"), "sum": row.get("sum"),
            "p95": quantile_from_buckets(
                row.get("base", 1.0), row.get("buckets") or [],
                int(row.get("count") or 0), row.get("min"), row.get("max"),
                0.95,
            ),
        }
    return {"n": len(row.get("values") or []),
            "last": (row.get("values") or [None])[-1]}


def diff_snapshots(a: dict, b: dict) -> dict:
    """Structured comparison of two metrics snapshots (a = baseline,
    b = candidate): ``{"added": {key: summary}, "removed": {...},
    "changed": {key: {"a", "b", "delta", "ratio"}}}``.  Counters and
    gauges get numeric delta + ratio; histograms compare count/sum and
    the interpolated p95; series compare length and last value.
    Unchanged metrics are omitted — an empty diff means the snapshots
    agree on every metric they share."""
    ka, kb = _by_key(a), _by_key(b)
    out = {
        "added": {k: _row_summary(kb[k]) for k in sorted(set(kb) - set(ka))},
        "removed": {k: _row_summary(ka[k]) for k in sorted(set(ka) - set(kb))},
        "changed": {},
    }
    for k in sorted(set(ka) & set(kb)):
        ra, rb = ka[k], kb[k]
        if ra.get("type") != rb.get("type"):
            out["changed"][k] = {
                "a": f"type={ra.get('type')}", "b": f"type={rb.get('type')}",
            }
            continue
        sa, sb = _row_summary(ra), _row_summary(rb)
        if sa == sb:
            continue
        entry: dict = {"a": sa, "b": sb}
        if isinstance(sa, (int, float)) and isinstance(sb, (int, float)):
            entry["delta"] = sb - sa
            entry["ratio"] = (sb / sa) if sa else None
        out["changed"][k] = entry
    return out


def render_diff(diff: dict) -> str:
    """Human-readable snapshot diff."""
    lines: List[str] = ["snapshot diff (a -> b):"]
    for k, s in diff.get("added", {}).items():
        lines.append(f"  + {k} = {json.dumps(s)}")
    for k, s in diff.get("removed", {}).items():
        lines.append(f"  - {k} = {json.dumps(s)}")
    for k, e in diff.get("changed", {}).items():
        extra = ""
        if "ratio" in e and e["ratio"] is not None:
            extra = f"  ({e['ratio']:.3g}x)"
        elif "delta" in e:
            extra = f"  (delta {e['delta']:+g})"
        lines.append(
            f"  ~ {k}: {json.dumps(e.get('a'))} -> {json.dumps(e.get('b'))}"
            f"{extra}"
        )
    n = sum(len(diff.get(k, {})) for k in ("added", "removed", "changed"))
    lines.append(f"{n} difference(s)" if n else "snapshots agree")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# flight-recorder attribution tables (obs.spans exports)
# ---------------------------------------------------------------------------

#: per-request table columns, in render order: the fabric legs come from
#: the on-device flight recorder (Delivery.attribution), the tick legs
#: from the span tick marks (exactly telescoping to ttft_ticks)
ATTR_COLUMNS = (
    "fabric.queue_wait", "fabric.stall", "fabric.transit",
    "fabric.defections", "admit_wait", "decode", "return", "ttft_ticks",
)


def attribution_rows(export: dict) -> List[dict]:
    """Flatten an ``obs.spans`` export into per-request attribution rows:
    one dict per request with label/degraded flags and every
    :data:`ATTR_COLUMNS` component present on the span."""
    rows = []
    for req in export.get("requests", ()):
        comp = dict(req.get("components") or {})
        comp.update(req.get("breakdown") or {})
        row = {
            "rid": req.get("rid"),
            "label": req.get("label"),
            "class": (req.get("args") or {}).get("cls"),
            "degraded": bool(req.get("degraded")),
            "reasons": ",".join(req.get("reasons") or ()),
            "done": bool(req.get("done")),
        }
        for c in ATTR_COLUMNS:
            if c in comp:
                row[c] = comp[c]
        rows.append(row)
    return rows


def render_attribution(export: dict) -> str:
    """The latency-attribution report: a per-request breakdown table plus
    per-class aggregate means — where each request's time went, column by
    column (fabric queue wait / stall / transit vs. admit wait / decode /
    return ticks)."""
    rows = attribution_rows(export)
    lines = [f"request attribution ({len(rows)} request(s)):"]
    if not rows:
        lines.append("  (no requests tracked)")
        return "\n".join(lines)
    cols = [c for c in ATTR_COLUMNS if any(c in r for r in rows)]
    hdr = ["rid", "label", "cls"] + [c.split(".")[-1] for c in cols] + ["flags"]
    table = [hdr]
    for r in rows:
        flags = []
        if r["degraded"]:
            flags.append(f"DEGRADED[{r['reasons']}]")
        if not r["done"]:
            flags.append("open")
        table.append(
            [str(r.get("rid")), str(r.get("label")),
             str(r.get("class", "") if r.get("class") is not None else "-")]
            + [f"{r[c]:g}" if c in r else "-" for c in cols]
            + [",".join(flags) or "ok"]
        )
    widths = [max(len(row[i]) for row in table) for i in range(len(hdr))]
    for row in table:
        lines.append("  " + "  ".join(c.ljust(w) for c, w in zip(row, widths)))
    # per-class aggregate (means per component)
    by_cls: Dict[object, List[dict]] = {}
    for r in rows:
        by_cls.setdefault(r.get("class"), []).append(r)
    if len(by_cls) > 1 or any(k is not None for k in by_cls):
        lines.append("per-class means:")
        for cls in sorted(by_cls, key=lambda c: (c is None, c)):
            grp = by_cls[cls]
            parts = []
            for c in cols:
                vals = [r[c] for r in grp if c in r]
                if vals:
                    parts.append(
                        f"{c.split('.')[-1]}={sum(vals) / len(vals):.2f}"
                    )
            lines.append(
                f"  class {cls if cls is not None else '-'} "
                f"(n={len(grp)}): " + " ".join(parts)
            )
    anomalies = export.get("anomalies") or []
    if anomalies:
        lines.append(f"anomalies ({len(anomalies)}):")
        for a in anomalies:
            lines.append(f"  !! {json.dumps(a)}")
    degraded = [r for r in rows if r["degraded"]]
    if degraded:
        lines.append(f"{len(degraded)} degraded request(s)")
    return "\n".join(lines)
