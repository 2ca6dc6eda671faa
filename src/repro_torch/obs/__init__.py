"""The telemetry plane of the port.

Carried over from the reference's ``obs`` package, module for module:

* **device counters + flight recorder** (:mod:`.counters`): layout of the
  int32 counter block the router scan accumulates on the device — and of
  the per-frame attribution columns (queue wait / stall / per-axis
  transit / defections) that ride with every frame — plus the host folds
  that turn per-rank deltas into the observed per-(link, direction) load
  matrix;
* **metrics registry** (:mod:`.metrics`): labeled Counter / Gauge /
  log2-bucket Histogram / Series with one ``snapshot()``, and the shared
  arrive-window statistics;
* **causal spans + SLOs** (:mod:`.spans`, :mod:`.slo`): request ids minted
  at ingress flow through mailbox / batcher / stream lanes / serve as one
  connected Perfetto arc, and declared latency/throughput targets
  evaluate against snapshots with burn-rate output;
* **export** (:mod:`.trace`, :mod:`.report`): Chrome-trace JSON
  timelines, text/JSON metric reports, snapshot diffs, attribution
  tables, plus ``python -m repro_torch.obs`` to summarize, ``--validate``,
  ``diff``, ``attribution`` or ``slo``; :mod:`.timeline` puts
  program spans and counters on a recorder's clock.

Everything here is host code, save the CUDA events of the timeline's
device spans; the trace clock is the host's ``time.perf_counter``, so a
traced run makes the same device syncs as an untraced one.  :func:`environment_meta` names torch, CUDA and the card.
"""
from .counters import (
    ATT_FIELDS,
    CTR_FIELDS,
    CTR_GLOBALS,
    FrameAttribution,
    att_transit_index,
    counters_to_dict,
    ctr_index,
    global_index,
    load_drift,
    n_att,
    n_counters,
    observed_link_loads,
    static_load_frames,
)
from .metrics import (
    SNAPSHOT_SCHEMA,
    ClassWindows,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
    format_key,
    quantile_from_buckets,
    validate_snapshot,
    window_stats,
)
from .report import (
    attribution_rows,
    diff_snapshots,
    environment_meta,
    render_attribution,
    render_diff,
    render_json,
    render_text,
)
from .slo import SLOReport, SLOResult, evaluate_slo, parse_slo
from .spans import RequestSpan, SpanEvent, SpanTracker, tick_breakdown
from .trace import TraceRecorder, validate_trace

__all__ = [
    "ATT_FIELDS",
    "CTR_FIELDS",
    "CTR_GLOBALS",
    "ClassWindows",
    "Counter",
    "FrameAttribution",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RequestSpan",
    "SLOReport",
    "SLOResult",
    "SNAPSHOT_SCHEMA",
    "Series",
    "SpanEvent",
    "SpanTracker",
    "TraceRecorder",
    "att_transit_index",
    "attribution_rows",
    "counters_to_dict",
    "ctr_index",
    "diff_snapshots",
    "environment_meta",
    "evaluate_slo",
    "format_key",
    "global_index",
    "load_drift",
    "n_att",
    "n_counters",
    "observed_link_loads",
    "parse_slo",
    "quantile_from_buckets",
    "render_attribution",
    "render_diff",
    "render_json",
    "render_text",
    "static_load_frames",
    "tick_breakdown",
    "validate_snapshot",
    "validate_trace",
    "window_stats",
]
