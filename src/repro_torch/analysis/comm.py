"""Static per-(link, direction) communication analysis (the ``plan_steps``
machinery, factored out of ``fabric/router.py``).

Frames route dimension-ordered, so while a frame crosses axis ``ai`` its
other coordinates are pinned (axes before ``ai`` already at the
destination, axes after still at the source); that tuple names the
physical ring the frame rides.  Frames on different rings — or moving in
opposite directions on one ring — never compete for a link, so per-axis
``{(ring, direction): LinkLoad}`` is the complete static load matrix of a
demand: :func:`demand_link_loads` builds it, :func:`bounds_from_loads`
turns it into the per-axis (scan steps, direction mask) bounds.
``Router.plan_steps`` composes exactly these two functions, so the load
matrix the analyzer reports and the scan bounds the router runs with can
never disagree.

Pure host integer math — importable and runnable with no devices.
"""
from __future__ import annotations

# NOTE: these constants are defined BEFORE any intra-repo import:
# fabric/router.py re-exports them at its module top, which may execute
# while THIS module is still initializing (analysis -> fabric -> router
# import chain), and a partially-initialized module only exposes what ran
# before the cycle re-entered.
#: direction masks for the per-axis scan bounds
DIR_FWD, DIR_BWD = 1, 2

import math  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: E402

from ..fabric.frames import frame_capacity  # noqa: E402

#: one axis of the load matrix: {(ring, direction): LinkLoad}
AxisLoads = Dict[Tuple[Tuple[int, int], int], "LinkLoad"]


@dataclass(frozen=True)
class LinkLoad:
    """Static demand on one (ring, direction) contention set."""

    frames: int  # frames riding this directed ring this tick
    max_hops: int  # farthest distance any of them travels on it


def demand_link_loads(
    sizes: Sequence[int],
    srcs: Sequence[int],
    dsts: Sequence[int],
    counts: Sequence[int],
    adaptive: bool,
) -> Tuple[AxisLoads, ...]:
    """The static load matrix of a demand: per axis, frames and max hops
    per (ring, direction) contention set.

    ``counts`` is in FRAMES (use :func:`demand_from_sends` /
    ``frame_capacity`` to derive it from message wires).  The ring id is
    ``(dst // (stride * n), src % stride)`` — axes before the current one
    already at the destination coordinates, axes after still at the
    source's — and with ``adaptive`` routing a frame whose +1 distance
    exceeds half the ring rides the -1 direction instead.
    """
    out: List[AxisLoads] = []
    for ai, n in enumerate(sizes):
        group: AxisLoads = {}
        if n == 1:
            out.append(group)
            continue
        stride = math.prod(sizes[ai + 1:])
        for s, d, cnt in zip(srcs, dsts, counts):
            sc = (s // stride) % n
            dc = (d // stride) % n
            fwd = (dc - sc) % n
            if fwd == 0 or cnt == 0:
                continue
            ring = (d // (stride * n), s % stride)
            if adaptive and fwd > n // 2:
                key, hops = (ring, DIR_BWD), n - fwd
            else:
                key, hops = (ring, DIR_FWD), fwd
            prev = group.get(key)
            group[key] = LinkLoad(
                cnt + (prev.frames if prev else 0),
                max(hops, prev.max_hops if prev else 0),
            )
        out.append(group)
    return tuple(out)


def bounds_from_loads(
    loads: Tuple[AxisLoads, ...],
    sizes: Sequence[int],
    credits: int,
    defect: int,
    defaults: Sequence[Tuple[int, int]],
) -> Tuple[Tuple[int, int], ...]:
    """Per-axis (scan steps, direction mask) from a load matrix.

    The busiest-contention-set bound per (ring, direction) is
    ``ceil(frames / credits) + max_hops + 1``; with defection enabled
    (``defect > 0``) a ring whose total load exceeds the per-step credit
    budget can starve frames into the opposite direction, so its two
    direction groups merge under the bound ``ceil(ring_frames / credits)
    + (n - 1) + defect + 1`` and both directions stay live.  Results are
    rounded up to an even step count (jit-cache bucketing) and never
    exceed ``defaults`` (the demand-blind worst case).
    """
    out: List[Tuple[int, int]] = []
    for ai, n in enumerate(sizes):
        group = loads[ai]
        if n == 1 or not group:
            out.append((0, 0))
            continue
        bounds: List[int] = []
        dirs = 0
        if defect:
            ring_frames: Dict[Tuple[int, int], int] = {}
            for (ring, _), ll in group.items():
                ring_frames[ring] = ring_frames.get(ring, 0) + ll.frames
            for ring, load in ring_frames.items():
                if load > credits:  # starvation (so defection) possible
                    bounds.append(-(-load // credits) + (n - 1) + defect + 1)
                    dirs |= DIR_FWD | DIR_BWD
                else:
                    for dmask in (DIR_FWD, DIR_BWD):
                        ll = group.get((ring, dmask))
                        if ll is not None:
                            bounds.append(
                                -(-ll.frames // credits) + ll.max_hops + 1
                            )
                            dirs |= dmask
        else:
            for (_, dmask), ll in group.items():
                bounds.append(-(-ll.frames // credits) + ll.max_hops + 1)
                dirs |= dmask
        steps = max(bounds)
        steps = min(steps + (steps % 2), defaults[ai][0])  # even bucket
        out.append((steps, dirs))
    return tuple(out)


def demand_from_sends(
    sends: Sequence[Tuple], frame_phits: int,
) -> Tuple[List[int], List[int], List[int]]:
    """(srcs, dsts, frame counts) of pending ``(src, dst, wire, ...)``
    sends — frames per message via ``frame_capacity`` (terminator
    included), matching what the mailbox will actually inject."""
    srcs = [s[0] for s in sends]
    dsts = [s[1] for s in sends]
    counts = [frame_capacity(len(s[2]), frame_phits) for s in sends]
    return srcs, dsts, counts


def busiest_links(
    loads: Tuple[AxisLoads, ...], top: int = 3,
) -> List[Tuple[int, Tuple[int, int], int, int, int]]:
    """The ``top`` most-loaded (axis, ring, direction) entries as
    ``(axis, ring, direction, frames, max_hops)`` — the human-report view
    of the load matrix."""
    rows = [
        (ai, ring, dmask, ll.frames, ll.max_hops)
        for ai, group in enumerate(loads)
        for (ring, dmask), ll in group.items()
    ]
    rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
    return rows[:top]


def total_frames(loads: Tuple[AxisLoads, ...],
                 axis: Optional[int] = None) -> int:
    """Frames crossing one axis (or the busiest axis when None)."""
    sums = [sum(ll.frames for ll in g.values()) for g in loads] or [0]
    return sums[axis] if axis is not None else max(sums)
