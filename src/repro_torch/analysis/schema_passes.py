"""Schema passes: static safety properties of HGum schemas.

The schema is data (the paper's core thesis), so its safety properties
are statically computable: wire-size and frame-count bounds
(:func:`wire_bounds`), ROM/stack capacity fits, ListLevel budgets, client
tag soundness (:func:`analyze_schema`), and decode-plan cap consistency
(:func:`analyze_plan_caps` — ``plan_from_wire``'s runtime cap error
becomes a compile-time finding).  Everything here is host-only math over
``core/idl.py`` / ``core/schema_tree.py``; no devices, no torch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.idl import (
    Array,
    Bytes,
    ClientSchema,
    ELEM,
    ListT,
    Schema,
    SchemaError,
    StreamT,
    StructRef,
    TypeNode,
    all_token_paths,
)
from ..core.schema_tree import (
    COUNT_BYTES,
    ROM_CAPACITY,
    STACK_CAPACITY,
    build_rom,
)
from ..core.stream_plans import (
    STREAM_ID_BITS,
    elem_size_error,
    meta_budget_error,
    stream_plans,
)
from .findings import Finding, Severity, finding
from .rules import MAX_LIST_LEVEL

_CONTAINER = (Array, ListT, StreamT)


# ---------------------------------------------------------------------------
# wire-size / frame-count bounds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WireBounds:
    """Static wire-size bounds of one message type (SW->HW layout: every
    container contributes its COUNT_BYTES count word; the minimum assumes
    every container is empty, the maximum is None when any container makes
    the wire unbounded)."""

    min_bytes: int
    max_bytes: Optional[int]

    def min_frames(self, frame_phits: int) -> int:
        """Fewest HW->HW frames a message can occupy (terminator incl.)."""
        from ..fabric.frames import frame_capacity

        return frame_capacity(self.min_bytes, frame_phits)

    def max_frames(self, frame_phits: int) -> Optional[int]:
        from ..fabric.frames import frame_capacity

        if self.max_bytes is None:
            return None
        return frame_capacity(self.max_bytes, frame_phits)


def wire_bounds(schema: Schema) -> WireBounds:
    """Static min/max wire bytes of ``schema``'s top message."""

    def bounds(t: TypeNode) -> Tuple[int, Optional[int]]:
        if isinstance(t, Bytes):
            return t.n, t.n
        if isinstance(t, StructRef):
            lo = hi = 0
            for _, ft in schema.structs[t.name]:
                flo, fhi = bounds(ft)
                lo += flo
                hi = None if hi is None or fhi is None else hi + fhi
            return lo, hi
        if isinstance(t, _CONTAINER):
            return COUNT_BYTES, None  # empty is legal; non-empty unbounded
        raise SchemaError(f"bad type {t!r}")

    return WireBounds(*bounds(StructRef(schema.top)))


# ---------------------------------------------------------------------------
# the schema pass
# ---------------------------------------------------------------------------


def _reachable(schema: Schema) -> set:
    seen = set()
    stack = [schema.top]
    while stack:
        s = stack.pop()
        if s in seen or s not in schema.structs:
            continue
        seen.add(s)
        for _, ftype in schema.structs[s]:
            t = ftype
            while isinstance(t, _CONTAINER):
                t = t.elem
            if isinstance(t, StructRef):
                stack.append(t.name)
    return seen


def analyze_schema(
    schema: Schema,
    client: Optional[ClientSchema] = None,
    caps: Optional[Dict[str, int]] = None,
    location: Optional[str] = None,
) -> List[Finding]:
    """Run every schema rule; returns the findings (empty = provably
    safe to build a ROM for and run through the FSM engines)."""
    loc = location or schema.top
    fs: List[Finding] = []
    try:
        schema.validate()
    except SchemaError as e:
        rule = ("schema-recursive" if "recursive" in str(e)
                else "schema-undefined-struct")
        return [finding(rule, loc, str(e))]

    reach = _reachable(schema)
    for sname in sorted(set(schema.structs) - reach):
        fs.append(finding(
            "schema-unreachable-struct", loc,
            f"struct {sname!r} is never reached from top "
            f"{schema.top!r}",
        ))
    try:
        rom = build_rom(schema)
    except SchemaError as e:
        # build_tree refuses empty inlined structs ("... has no fields")
        fs.append(finding("schema-empty-struct", loc, str(e)))
        return fs

    b = rom.static_bounds()
    if b["n_nodes"] > ROM_CAPACITY:
        fs.append(finding(
            "schema-rom-capacity", loc,
            f"schema tree flattens to {b['n_nodes']} ROM entries, over "
            f"the {ROM_CAPACITY}-entry schema-ROM capacity",
        ))
    if b["stack_depth"] > STACK_CAPACITY:
        fs.append(finding(
            "schema-stack-depth", loc,
            f"container nesting needs a {b['stack_depth']}-deep context "
            f"stack, over the {STACK_CAPACITY}-deep capacity",
        ))
    if b["max_list_level"] > MAX_LIST_LEVEL:
        fs.append(finding(
            "schema-list-level-overflow", loc,
            f"List nesting reaches level {b['max_list_level']}, over the "
            f"u8 ListLevel header budget of {MAX_LIST_LEVEL}",
        ))

    if client is not None:
        valid = set(all_token_paths(schema))
        for path in sorted(client.tags):
            if path not in valid:
                fs.append(finding(
                    "client-unknown-path", loc,
                    f"client-schema path {path!r} does not name a token "
                    f"of {schema.top!r}",
                ))
        by_tag: Dict[int, List[str]] = {}
        for path, tag in client.tags.items():
            by_tag.setdefault(tag, []).append(path)
        for tag, paths in sorted(by_tag.items()):
            if len(paths) > 1:
                fs.append(finding(
                    "client-tag-collision", loc,
                    f"tag {tag} is shared by paths "
                    f"{sorted(paths)} — DES output would be ambiguous",
                ))

    if caps is not None:
        fs.extend(analyze_plan_caps(schema, caps, location=loc))
    return fs


# ---------------------------------------------------------------------------
# typed-stream pass (core/stream_plans.py's runtime errors, statically)
# ---------------------------------------------------------------------------


def analyze_stream_schema(
    schema: Schema,
    location: Optional[str] = None,
    *,
    id_bits: int = 2 * STREAM_ID_BITS,
    step_bits: int = STREAM_ID_BITS,
) -> List[Finding]:
    """Run the schema rules plus the ``stream-*`` rules over a schema
    that declares ``Stream<T>`` nodes.

    The stream checks wrap the exact functions the runtime raises with
    (:func:`~repro_torch.core.stream_plans.meta_budget_error`,
    :func:`~repro_torch.core.stream_plans.elem_size_error`), so a finding here
    is word-for-word the ``SchemaError`` ``stream_plans`` /
    ``StreamPlan`` would raise.  Also proves the serve plane's
    ``(request:u16 | prompt:u16)`` id packing fits the plan's id budget
    (rule ``stream-id-width``)."""
    loc = location or schema.top
    fs = analyze_schema(schema, location=loc)
    if any(f.severity is Severity.ERROR for f in fs):
        return fs  # the ROM below these checks would not even build

    budget_err = meta_budget_error(id_bits, step_bits)
    if budget_err is not None:
        fs.append(finding("stream-meta-budget", loc, budget_err))
        # fall back to the shipped budgets so the element checks still run
        id_bits, step_bits = 2 * STREAM_ID_BITS, STREAM_ID_BITS
    try:
        plans = stream_plans(schema, id_bits=id_bits, step_bits=step_bits)
    except SchemaError as e:
        # non-fixed-size element, or element too wide for the plan ctor
        fs.append(finding("stream-elem-size", loc, str(e)))
        return fs

    for path, plan in sorted(plans.items()):
        size_err = elem_size_error(plan.elem_words)
        if size_err is not None:  # unreachable today: the ctor re-checks
            fs.append(finding("stream-elem-size", loc, f"{path}: {size_err}"))
        if plan.id_bits < 2 * STREAM_ID_BITS:
            fs.append(finding(
                "stream-id-width", loc,
                f"{path}: id budget of {plan.id_bits} bits cannot hold "
                f"the serve plane's (request:u{STREAM_ID_BITS} | "
                f"prompt:u{STREAM_ID_BITS}) stream-id packing",
            ))
    return fs


# ---------------------------------------------------------------------------
# decode-plan caps (vectorized.plan_from_wire's error, statically)
# ---------------------------------------------------------------------------


def _paths_with_parents(schema: Schema) -> List[Tuple[str, Optional[str]]]:
    """Every plan path with its nearest enclosing container path."""
    out: List[Tuple[str, Optional[str]]] = []

    def walk(t: TypeNode, path: str, parent: Optional[str]) -> None:
        if isinstance(t, Bytes):
            out.append((path, parent))
        elif isinstance(t, StructRef):
            for f, ft in schema.structs[t.name]:
                walk(ft, f"{path}.{f}" if path else f, parent)
        elif isinstance(t, _CONTAINER):
            out.append((path, parent))
            walk(t.elem, f"{path}.{ELEM}", path)

    for f, ft in schema.structs[schema.top]:
        walk(ft, f, None)
    return out


def analyze_plan_caps(
    schema: Schema, caps: Dict[str, int], location: Optional[str] = None,
) -> List[Finding]:
    """Static consistency of a ``build_plan``/``plan_from_wire`` caps
    dict: each cap must fit the u32 count field, and an inner path's
    cap below its enclosing container's cap overflows the moment every
    container instance holds one element (``plan_from_wire`` raises
    '{path}: N instances exceed cap' at runtime)."""
    loc = location or schema.top
    fs: List[Finding] = []
    count_mod = 1 << (8 * COUNT_BYTES)
    for path, cap in sorted(caps.items()):
        if cap >= count_mod:
            fs.append(finding(
                "plan-cap-count-width", loc,
                f"cap {cap} for {path!r} exceeds the "
                f"{COUNT_BYTES}-byte count field (max {count_mod - 1})",
            ))
    for path, parent in _paths_with_parents(schema):
        if parent is None or path not in caps or parent not in caps:
            continue
        if caps[path] < caps[parent]:
            fs.append(finding(
                "plan-cap-overflow", loc,
                f"cap {caps[path]} for {path!r} is below enclosing "
                f"{parent!r}'s cap {caps[parent]}: one element per "
                f"instance already overflows (plan_from_wire would "
                f"raise '{path}: N instances exceed cap "
                f"{caps[path]}')",
            ))
    return fs


def message_wire_len(schema: Schema, msg: dict) -> int:
    """Exact SW->HW wire bytes of one concrete message (bounds check
    helper for tests: min_bytes <= this <= max_bytes always holds)."""

    def size(t: TypeNode, v) -> int:
        if isinstance(t, Bytes):
            return t.n
        if isinstance(t, StructRef):
            return sum(size(ft, v[f]) for f, ft in schema.structs[t.name])
        if isinstance(t, _CONTAINER):
            return COUNT_BYTES + sum(size(t.elem, e) for e in v)
        raise SchemaError(f"bad type {t!r}")

    return int(np.sum([
        size(ft, msg[f]) for f, ft in schema.structs[schema.top]
    ], dtype=np.int64))
