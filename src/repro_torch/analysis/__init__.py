"""repro_torch.analysis: the static schema + fabric-communication analyzer.

Carried over from the reference's ``analysis`` package.  The schema is
data, so wire bounds, ROM/stack fits, tag soundness, field-width budgets,
per-link fabric load, and credit/QoS liveness are all computable at
construction time.  ``python -m repro_torch.analysis`` runs every pass
over every shipped target; ``Fabric(analyze=True)`` /
``serve_requests_*(analyze=True)`` run them inline and raise on ERROR
findings with the rule's fix hint.  All host-only integer math.

Import discipline: ``findings`` and ``rules`` load eagerly (the fabric
package imports them at module top); everything touching the fabric
package itself (``fabric_passes``, ``comm``, ``targets``) loads lazily
via PEP 562 so ``repro_torch.fabric -> repro_torch.analysis.rules`` never
re-enters a half-initialized fabric.
"""
from __future__ import annotations

from .findings import (
    Finding,
    Report,
    Rule,
    RULES,
    Severity,
    assert_clean,
    finding,
)
from .rules import (
    MAX_LIST_LEVEL,
    fabric_config_findings,
    list_level_error,
    max_ranks_error,
)
from .schema_passes import (
    WireBounds,
    analyze_plan_caps,
    analyze_schema,
    analyze_stream_schema,
    message_wire_len,
    wire_bounds,
)

__all__ = [
    "Finding", "Report", "Rule", "RULES", "Severity", "assert_clean",
    "finding",
    "MAX_LIST_LEVEL", "fabric_config_findings", "list_level_error",
    "max_ranks_error",
    "WireBounds", "analyze_plan_caps", "analyze_schema",
    "analyze_stream_schema", "message_wire_len", "wire_bounds",
    # lazy (fabric-touching):
    "analyze_fabric", "analyze_fabric_values", "analyze_demand",
    "analyze_sends", "demand_link_loads", "bounds_from_loads",
    "busiest_links", "total_frames", "LinkLoad",
    "analyze_model_config", "run_all",
]

_LAZY = {
    "analyze_fabric": "fabric_passes",
    "analyze_fabric_values": "fabric_passes",
    "analyze_demand": "fabric_passes",
    "analyze_sends": "fabric_passes",
    "demand_link_loads": "comm",
    "bounds_from_loads": "comm",
    "busiest_links": "comm",
    "total_frames": "comm",
    "LinkLoad": "comm",
    "analyze_model_config": "config_passes",
    "run_all": "__main__",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
