"""Static fabric-communication analysis: the host rules the fabric shares.

Carried over by copy from the reference's ``analysis`` package, as far as
the routed fabric needs it: the findings model (``findings``), the
validation rules the fabric and ``FabricConfig`` raise verbatim
(``rules``), and the static per-(link, direction) load matrix and scan
bounds that ``Router.plan_steps`` composes (``comm``).  The schema,
fabric and config passes and the ``python -m`` CLI are not ported yet.

Import discipline: ``findings`` and ``rules`` load eagerly (the fabric
imports them at module top); ``comm`` imports the fabric's ``frames``
module and loads lazily (PEP 562), so ``fabric -> analysis.rules`` never
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

__all__ = [
    "Finding", "Report", "Rule", "RULES", "Severity", "assert_clean",
    "finding",
    "MAX_LIST_LEVEL", "fabric_config_findings", "list_level_error",
    "max_ranks_error",
    # lazy (fabric-touching):
    "demand_link_loads", "bounds_from_loads", "busiest_links",
    "total_frames", "LinkLoad",
]

_LAZY = {
    "demand_link_loads": "comm",
    "bounds_from_loads": "comm",
    "busiest_links": "comm",
    "total_frames": "comm",
    "LinkLoad": "comm",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
