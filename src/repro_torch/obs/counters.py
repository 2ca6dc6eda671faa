"""On-device fabric counter block: layout + host-side folds.

The router scan carry (``fabric/router.py``) accumulates a small int32
counter vector per device — entirely device-side, returned alongside the
delivered frames, so the fused no-host-sync tick stays sync-free.  This
module owns the *layout* of that vector and the host-side folds that turn
per-rank counter deltas into human/machine aggregates, most importantly
the **observed per-(link, direction) load matrix** shaped exactly like the
static ``repro.analysis.comm.demand_link_loads`` matrix, so static-vs-
observed drift is a first-class, assertable signal.

Layout (per device, ``n_counters(n_axes)`` int32 slots)::

    [axis 0 fwd | axis 0 bwd | axis 1 fwd | ... ] [delivered, crc_fail]

with each (axis, direction) block holding :data:`CTR_FIELDS`:

* ``entered``   — frames taking their FIRST hop on this (axis, direction)
  (the device's axis coordinate still equals the frame's source
  coordinate).  A frame enters each axis at most once, so summing entered
  over a ring's devices counts *frames riding the ring* — the exact
  quantity ``demand_link_loads`` predicts statically.
* ``forwarded`` — frames moved one hop (link occupancy; transit frames
  count once per hop, so ``forwarded >= entered``).
* ``starved``   — scan steps where eligible demand was left waiting by
  this direction's credit budget (the defection trigger signal).
* ``defect_out``— frames that defected AWAY from this (preferred)
  direction after ``defect_after`` straight starved steps.
* ``spare_in``  — defectors admitted INTO this direction's spare credits
  (post-natural-traffic); globally ``sum(defect_out) == sum(spare_in)``.
* ``spilled``   — frames admitted via the QoS weighted-round-robin
  work-conserving spill (credits a class left unused, consumed by
  another class's frames).
* ``occupied``  — scan steps where this device held eligible demand for
  this direction (counts *events*, not loop trips, so fused and
  three-program ticks agree bit-for-bit even when their static scan
  bounds differ).

Globals: ``delivered`` (frames appended to this device's RX, self-sends
included) and ``crc_fail`` (delivered frames failing their CRC32).

This module is import-pure (no jax, no intra-repo imports at module
scope) so the router can depend on it without cycles.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

#: per-(axis, direction) counter fields, in slot order
CTR_FIELDS: Tuple[str, ...] = (
    "entered", "forwarded", "starved", "defect_out", "spare_in",
    "spilled", "occupied",
)
N_FIELDS = len(CTR_FIELDS)
#: per-device global counters appended after the (axis, direction) blocks
CTR_GLOBALS: Tuple[str, ...] = ("delivered", "crc_fail")

#: direction slot order within an axis (maps to analysis.comm DIR_* masks)
DIR_SLOTS = ("fwd", "bwd")


def n_counters(n_axes: int) -> int:
    """Length of one device's counter vector."""
    return n_axes * len(DIR_SLOTS) * N_FIELDS + len(CTR_GLOBALS)


def ctr_index(ai: int, dir_slot: int, field: str) -> int:
    """Slot of ``field`` for (axis ``ai``, direction slot 0=fwd/1=bwd)."""
    return (ai * len(DIR_SLOTS) + dir_slot) * N_FIELDS + \
        CTR_FIELDS.index(field)


def global_index(n_axes: int, field: str) -> int:
    return n_axes * len(DIR_SLOTS) * N_FIELDS + CTR_GLOBALS.index(field)


def counters_to_dict(axis_names: Sequence[str],
                     ctr: Sequence[int]) -> Dict[str, int]:
    """One device's (or a summed) counter vector as a flat name->value
    dict: ``link.<field>{axis=<name>,dir=fwd|bwd}`` plus the globals."""
    n_axes = len(axis_names)
    out: Dict[str, int] = {}
    for ai, axis in enumerate(axis_names):
        for di, dname in enumerate(DIR_SLOTS):
            for field in CTR_FIELDS:
                key = f"link.{field}{{axis={axis},dir={dname}}}"
                out[key] = int(ctr[ctr_index(ai, di, field)])
    for field in CTR_GLOBALS:
        out[field] = int(ctr[global_index(n_axes, field)])
    return out


# ---------------------------------------------------------------------------
# Per-frame attribution columns (the flight recorder)
#
# Where the counter block above aggregates *events per device*, the
# attribution block rides WITH each frame through the link-buffer
# ppermute: ``n_att(n_axes)`` int32 columns appended to the frame's
# queue-side state, updated once per executed scan step, delivered
# alongside the frame.  Layout::
#
#     [enter_step, stall, wait, defections, transit axis 0, transit axis 1, ...]
#
# * ``enter_step`` — the 1-based ``step_no`` of the frame's FIRST hop
#   (0 == never hopped, i.e. a self-send delivered before the scan).
# * ``stall``     — steps the frame was eligible on the active axis but
#   left waiting by credits/QoS (starvation, the defection trigger).
# * ``wait``      — steps the frame sat queued but NOT eligible on the
#   active axis (ingress queue wait: wrong-axis phase or already home).
# * ``defections``— times the frame defected to the opposite direction.
# * ``transit[ai]`` — hops the frame took on axis ``ai``.
#
# At every executed step a live queued frame lands in exactly one of
# {hopped, stalled, waiting}, so the per-frame invariant
# ``wait + stall + sum(transit) == arrive_step`` holds EXACTLY, and —
# because the updates are per-event like ``occupied`` — bit-identically
# across the fused and three-program engines.

#: fixed attribution slots, before the per-axis transit block
ATT_FIELDS: Tuple[str, ...] = ("enter_step", "stall", "wait", "defections")
ATT_ENTER, ATT_STALL, ATT_WAIT, ATT_DEFECT = 0, 1, 2, 3
N_ATT_FIXED = len(ATT_FIELDS)


def n_att(n_axes: int) -> int:
    """Width of one frame's attribution vector."""
    return N_ATT_FIXED + n_axes


def att_transit_index(ai: int) -> int:
    """Column of axis ``ai``'s transit (hop) count."""
    return N_ATT_FIXED + ai


@dataclass(frozen=True)
class FrameAttribution:
    """Host-side view of one delivered frame's attribution vector.

    ``queue_wait + stall + total_transit == arrive_step`` exactly, on
    every engine and routing mode (property-tested).  For a multi-frame
    message the :class:`~repro.fabric.mailbox.Delivery` carries the
    attribution of its *critical* frame — the one that arrived last."""

    enter_step: int = 0
    stall: int = 0
    wait: int = 0
    defections: int = 0
    transit: Tuple[int, ...] = field(default_factory=tuple)

    @property
    def total_transit(self) -> int:
        return sum(self.transit)

    @property
    def arrive_step(self) -> int:
        """The reconstructed arrival step (== ``Delivery.arrive_step``)."""
        return self.wait + self.stall + self.total_transit

    def components(self) -> Dict[str, int]:
        """Flat dict for reports: queue_wait / stall / transit / defections."""
        return {
            "queue_wait": self.wait,
            "stall": self.stall,
            "transit": self.total_transit,
            "defections": self.defections,
        }

    @classmethod
    def from_vector(cls, n_axes: int, vec: Sequence[int]) -> "FrameAttribution":
        return cls(
            enter_step=int(vec[ATT_ENTER]),
            stall=int(vec[ATT_STALL]),
            wait=int(vec[ATT_WAIT]),
            defections=int(vec[ATT_DEFECT]),
            transit=tuple(int(vec[att_transit_index(a)]) for a in range(n_axes)),
        )


def observed_link_loads(
    sizes: Sequence[int], per_rank_ctr: Sequence[Sequence[int]],
) -> Tuple[Dict[Tuple[Tuple[int, int], int], int], ...]:
    """Fold per-rank ``entered`` counters into the observed load matrix,
    keyed exactly like ``analysis.comm.demand_link_loads``: per axis,
    ``{((ring_hi, ring_lo), direction_mask): frames}``.

    A frame's first hop on an axis happens on the device whose axis
    coordinate equals the frame's source coordinate — i.e. *somewhere on
    the ring the frame rides* — and every ring device folds into the same
    ring id, so summing ``entered`` over ranks reproduces the static
    per-(ring, direction) frame counts for any deterministic demand.
    Zero-count keys are omitted (matching the static matrix, which only
    holds rings with demand)."""
    import math

    from ..analysis.comm import DIR_BWD, DIR_FWD

    masks = (DIR_FWD, DIR_BWD)  # index-aligned with DIR_SLOTS
    out: List[Dict[Tuple[Tuple[int, int], int], int]] = []
    for ai, n in enumerate(sizes):
        group: Dict[Tuple[Tuple[int, int], int], int] = {}
        if n > 1:
            stride = math.prod(sizes[ai + 1:])
            for r, ctr in enumerate(per_rank_ctr):
                ring = (r // (stride * n), r % stride)
                for di, dmask in enumerate(masks):
                    frames = int(ctr[ctr_index(ai, di, "entered")])
                    if frames:
                        key = (ring, dmask)
                        group[key] = group.get(key, 0) + frames
        out.append(group)
    return tuple(out)


def static_load_frames(
    loads: Sequence[Dict],
) -> Tuple[Dict[Tuple[Tuple[int, int], int], int], ...]:
    """Project a static ``demand_link_loads`` matrix (LinkLoad values)
    onto plain frame counts — the comparable view of the static side."""
    return tuple(
        {key: ll.frames for key, ll in group.items()} for group in loads
    )


def load_drift(
    expected: Sequence[Dict[Tuple[Tuple[int, int], int], int]],
    observed: Sequence[Dict[Tuple[Tuple[int, int], int], int]],
) -> Dict[Tuple[int, Tuple[int, int], int], Tuple[int, int]]:
    """Static-vs-observed divergence: ``{(axis, ring, direction):
    (expected_frames, observed_frames)}`` for every key where the two
    matrices disagree.  Empty dict == no drift — the assertable signal
    (a dropped, misrouted, or defected frame shows up as a nonzero
    entry on the link it should have ridden)."""
    out: Dict[Tuple[int, Tuple[int, int], int], Tuple[int, int]] = {}
    for ai in range(max(len(expected), len(observed))):
        e = expected[ai] if ai < len(expected) else {}
        o = observed[ai] if ai < len(observed) else {}
        for key in set(e) | set(o):
            ev, ov = int(e.get(key, 0)), int(o.get(key, 0))
            if ev != ov:
                out[(ai,) + key] = (ev, ov)
    return out
