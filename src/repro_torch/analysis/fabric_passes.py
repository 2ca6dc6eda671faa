"""Fabric/communication passes: prove a fabric config + demand safe
before any device allocation.

:func:`analyze_fabric_values` checks raw config values (so invalid
combinations that ``FabricConfig.__post_init__`` would refuse to even
construct still get findings), :func:`analyze_fabric` checks a live
:class:`~repro_torch.fabric.mailbox.Fabric`, and :func:`analyze_demand` /
:func:`analyze_sends` check a concrete demand matrix against a topology:
per-(link, direction) static load via the ``plan_steps`` machinery
(:mod:`.comm`), rank ranges, rx-capacity overflow, and u16 seq-window
aliasing.  All host-only integer math.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from .comm import AxisLoads, demand_from_sends, demand_link_loads
from .findings import Finding, finding
from .rules import (
    fabric_config_findings,
    list_level_error,
    max_ranks_error,
)


def analyze_fabric_values(
    *,
    frame_phits: int = 16,
    credits: int = 4,
    routing: str = "shortest",
    defect_after: int = 0,
    qos_weights: Optional[Tuple[int, ...]] = None,
    rx_frames: Optional[int] = None,
    n_ranks: Optional[int] = None,
    sizes: Optional[Sequence[int]] = None,
    arq: bool = False,
    retransmit_timeout: int = 8,
    max_retries: int = 4,
    arq_buffer: int = 1024,
    arq_level: int = 255,
    arq_skip_after: int = 0,
    suspect_after: Optional[int] = None,
    location: str = "FabricConfig",
) -> List[Finding]:
    """Analyze raw fabric-config values (no FabricConfig construction, so
    combinations its ``__post_init__`` raises on still produce findings
    instead of exceptions)."""
    fs = fabric_config_findings(
        frame_phits, credits, routing, defect_after, qos_weights,
        sizes=sizes, location=location,
        arq=arq, retransmit_timeout=retransmit_timeout,
        max_retries=max_retries, arq_buffer=arq_buffer,
        arq_level=arq_level, arq_skip_after=arq_skip_after,
        suspect_after=suspect_after,
    )
    if rx_frames is not None and rx_frames < 1:
        fs.append(finding(
            "fabric-config-positive", location,
            f"rx_frames must be >= 1 when set, got {rx_frames}",
        ))
    total = n_ranks
    if total is None and sizes:
        total = math.prod(sizes)
    if total is not None:
        err = max_ranks_error(total)
        if err is not None:
            fs.append(finding("fabric-max-ranks", location, err))
    return fs


def analyze_fabric(fabric, location: Optional[str] = None) -> List[Finding]:
    """Analyze a live Fabric: its config against its topology sizes."""
    cfg = fabric.config
    sizes = tuple(fabric.router.sizes)
    return analyze_fabric_values(
        frame_phits=cfg.frame_phits,
        credits=cfg.credits,
        routing=cfg.routing,
        defect_after=cfg.defect_after,
        qos_weights=cfg.qos_weights,
        rx_frames=cfg.rx_frames,
        n_ranks=fabric.n_ranks,
        sizes=sizes,
        arq=cfg.arq,
        retransmit_timeout=cfg.retransmit_timeout,
        max_retries=cfg.max_retries,
        arq_buffer=cfg.arq_buffer,
        arq_level=cfg.arq_level,
        arq_skip_after=cfg.arq_skip_after,
        location=location or f"Fabric(n_ranks={fabric.n_ranks})",
    )


def analyze_demand(
    sizes: Sequence[int],
    config,
    srcs: Sequence[int],
    dsts: Sequence[int],
    counts: Sequence[int],
    levels: Optional[Sequence[int]] = None,
    location: str = "demand",
) -> Tuple[Tuple[AxisLoads, ...], List[Finding]]:
    """Analyze one tick's demand matrix (``counts`` in frames) against a
    topology + config.  Returns ``(loads, findings)`` — the per-axis
    per-(ring, direction) static load matrix plus any findings.

    Checks: src/dst rank ranges, send ListLevel budgets, per-(src, dst)
    u16 seq-window aliasing, and — when ``config.rx_frames`` is set — the
    per-destination rx-buffer capacity (with ``rx_frames=None`` the
    mailbox sizes rx from the tick itself and cannot overflow).
    """
    from ..fabric.frames import SEQ_MOD

    n_ranks = math.prod(sizes)
    fs: List[Finding] = []
    for i, (s, d) in enumerate(zip(srcs, dsts)):
        if not (0 <= s < n_ranks and 0 <= d < n_ranks):
            fs.append(finding(
                "fabric-rank-range", location,
                f"demand entry {i} routes {s} -> {d}, outside the "
                f"{n_ranks}-rank fabric [0, {n_ranks - 1}]",
            ))
    if levels is not None:
        for i, lvl in enumerate(levels):
            err = list_level_error(lvl)
            if err is not None:
                fs.append(finding(
                    "fabric-list-level", location,
                    f"demand entry {i}: {err}",
                ))
    if fs:  # loads of an unroutable demand are meaningless
        return (tuple({} for _ in sizes), fs)

    stream_frames: Dict[Tuple[int, int], int] = {}
    rx_total: Dict[int, int] = {}
    for s, d, cnt in zip(srcs, dsts, counts):
        key = (s, d)
        stream_frames[key] = stream_frames.get(key, 0) + int(cnt)
        if s != d:
            rx_total[d] = rx_total.get(d, 0) + int(cnt)
    for (s, d), frames in sorted(stream_frames.items()):
        if frames >= SEQ_MOD:
            fs.append(finding(
                "fabric-seq-window", location,
                f"{frames} frames from {s} to {d} in one tick alias the "
                f"u16 seq window (SEQ_MOD={SEQ_MOD})",
            ))
    if config.rx_frames is not None:
        for d, frames in sorted(rx_total.items()):
            if frames > config.rx_frames:
                fs.append(finding(
                    "fabric-rx-overflow", location,
                    f"rank {d} receives {frames} frames this tick, over "
                    f"the configured rx_frames={config.rx_frames} buffer",
                ))

    loads = demand_link_loads(sizes, srcs, dsts, counts, config.adaptive)
    return loads, fs


def analyze_sends(
    sizes: Sequence[int], config, sends: Sequence[Tuple],
    location: str = "pending sends",
) -> Tuple[Tuple[AxisLoads, ...], List[Finding]]:
    """Analyze pending mailbox sends ``(src, dst, wire, level, ...)`` —
    the ``Fabric(analyze=True)`` per-tick hook path."""
    srcs, dsts, counts = demand_from_sends(sends, config.frame_phits)
    levels = [s[3] for s in sends if len(s) > 3] or None
    return analyze_demand(
        sizes, config, srcs, dsts, counts, levels=levels,
        location=location,
    )
