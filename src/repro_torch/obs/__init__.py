"""The telemetry plane, as far as the routed fabric needs it.

Carried over by copy from the reference's ``obs`` package:

* **device counters + flight recorder** (:mod:`.counters`): layout of the
  int32 counter block the router scan accumulates on the device — and of
  the per-frame attribution columns (queue wait / stall / per-axis
  transit / defections) that ride with every frame — plus the host folds
  that turn per-rank deltas into the observed per-(link, direction) load
  matrix;
* **metrics registry** (:mod:`.metrics`): labeled Counter / Gauge /
  log2-bucket Histogram / Series with one ``snapshot()``, and the shared
  arrive-window statistics.

Spans, trace export, reports and SLOs are not ported yet.
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
    "SNAPSHOT_SCHEMA",
    "Series",
    "att_transit_index",
    "counters_to_dict",
    "ctr_index",
    "format_key",
    "global_index",
    "load_drift",
    "n_att",
    "n_counters",
    "observed_link_loads",
    "quantile_from_buckets",
    "static_load_frames",
    "validate_snapshot",
    "window_stats",
]
