"""Multi-hop frame router over a rank axis of tensors, on one card.

Counterpart of the reference's ``fabric/router.py``, which delivers frames
between the devices of a JAX mesh by composing ``jax.lax.ppermute`` steps
inside one ``shard_map`` program per device.  Here every rank is a row of
one tensor: the per-device program becomes ONE program over a leading
``(R, ...)`` rank axis, ``axis_index`` becomes ``arange(R)``, each
``ppermute`` becomes a roll of the link buffers along that axis of the
rank grid (``(sizes..., credits, ·)`` view), and the global ``psum`` that
ends an early-exit scan becomes an ``any`` over all ranks.  Deliveries,
arrival steps, the per-frame attribution and the counter block are the
reference's bit for bit, on both tick engines.

Topology and algorithm (the reference's, unchanged):

* Ranks are the row-major flattening of the grid coordinates (a ``(4, 2)``
  grid has ``rank = x*2 + y``).
* **Dimension-ordered routing**: frames travel along the first axis until
  their destination coordinate matches, then along the next, and so on.
* **Shortest-path direction choice** (``routing="shortest"``, default): on
  each axis a frame whose +1 distance exceeds half the ring takes the -1
  direction (gated per frame by the route word's adaptive bit); both
  directions move every step, each with its own credits and QoS pass.
* **Credit-based flow control**: at most ``credits`` frames per directed
  link per step; transit frames re-queue ahead of fresh injections.
* **Direction defection** (``defect_after = k``): an adaptive frame whose
  preferred link starved ``k`` straight steps may take the other direction
  into its spare credits, and commits to it for the rest of the axis.
* **Early-exit scans** (``early_exit``): each axis scan stops as soon as
  no rank still holds a frame needing the axis; the static bound is a cap.
  In eager torch the test is one host sync per scan step.
* **QoS credit classes** (``qos_weights``): weighted round-robin over
  ``ListLevel % n_classes`` with work-conserving spill.

Dropped writes are explicit: where the reference scatters with
``mode="drop"``, the port scatters into one spare trash row past the end
of the buffer and slices it off (no host sync).

Two delivery entry points, as in the reference:

* :meth:`Router.deliver` — already-framed ``(ranks, T, width)`` TX buffers
  (the three-program engine; ``mailbox.py`` frames and scatters first).
* :meth:`Router.deliver_fused` — the whole tick in one call: batched
  framing, the ``pack_frames_batch`` kernel, the routed scan and the
  ``unpack_frames_batch`` kernel, with frames on the device throughout.
  (The reference's fused engine joins and splits frames with
  ``jnp.concatenate`` and slicing; the port launches the two kernels,
  which compute the same function.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, default_device
from .frames import (
    HDR_LEVEL,
    HDR_WORDS,
    PHIT_WORDS,
    route_adaptive,
    route_dst,
    route_src,
    verify_frames,
)

#: on-device counter-block and per-frame attribution layouts
from ..obs.counters import (
    ATT_DEFECT,
    ATT_ENTER,
    ATT_STALL,
    ATT_WAIT,
    N_ATT_FIXED,
    ctr_index,
    global_index,
    n_att,
    n_counters,
)

#: shared validation rules: the runtime raises the analyzer's words
from ..analysis.findings import Severity
from ..analysis.rules import fabric_config_findings, max_ranks_error

#: direction masks for plan_steps / the per-axis scan, shared with the
#: communication pass (defined there before any import: cycle-safe)
from ..analysis.comm import DIR_BWD, DIR_FWD

_CTR_FIELDS = ("entered", "forwarded", "starved", "defect_out", "spare_in",
               "spilled", "occupied")


@dataclass(frozen=True)
class FabricConfig:
    """Knobs of the routed fabric (the reference's, field for field)."""

    frame_phits: int = 16  # payload phits per frame
    credits: int = 4  # max in-flight frames per directed link per step
    rx_frames: Optional[int] = None  # per-rank delivery capacity (default R*T)
    #: weighted round-robin credit classes at the inject step, keyed by
    #: ``ListLevel % len(qos_weights)``.  None = single-class FIFO.
    qos_weights: Optional[Tuple[int, ...]] = None
    #: "shortest" = per-frame direction choice; "dimension" = +1 only
    routing: str = "shortest"
    #: run the tick as one call (pack -> route -> RX split) instead of
    #: three stages with host copies between them.  The three-stage
    #: engine remains for ``Fabric.tx_hook`` and as the regression oracle.
    fused: bool = True
    #: direction defection after this many consecutive starved steps
    #: (0 = off: the static per-frame shortest-path choice)
    defect_after: int = 0
    #: stop each axis scan once no rank holds a frame needing the axis
    early_exit: bool = True
    #: ARQ reliability layer (``mailbox.py``); off = flag-only delivery
    arq: bool = False
    #: ticks without an ACK before a sender retransmits unprompted
    #: (doubles per retry, capped at 32x)
    retransmit_timeout: int = 8
    #: retransmits per message before the sender dead-letters it
    max_retries: int = 4
    #: retransmit-buffer bound per (src, dst) stream, in FRAMES
    arq_buffer: int = 1024
    #: ListLevel the ACK/NACK control frames ride (reserved while arq is on)
    arq_level: int = 255
    #: receiver give-up horizon in ticks (0 = timeout * (max_retries + 2))
    arq_skip_after: int = 0
    #: receiver cumulative-ACK cadence in ticks
    arq_ack_every: int = 2

    def __post_init__(self) -> None:
        # the analyzer's rules are the single source of these checks:
        # construction raises the first ERROR finding's message verbatim
        for f in fabric_config_findings(
            self.frame_phits, self.credits, self.routing,
            self.defect_after, self.qos_weights,
            arq=self.arq, retransmit_timeout=self.retransmit_timeout,
            max_retries=self.max_retries, arq_buffer=self.arq_buffer,
            arq_level=self.arq_level, arq_skip_after=self.arq_skip_after,
        ):
            if f.severity is Severity.ERROR:
                raise ValueError(f.message)

    @property
    def skip_after(self) -> int:
        """Effective receiver give-up horizon."""
        if self.arq_skip_after > 0:
            return self.arq_skip_after
        return self.retransmit_timeout * (self.max_retries + 2)

    @property
    def frame_width(self) -> int:
        return HDR_WORDS + self.frame_phits * PHIT_WORDS

    @property
    def adaptive(self) -> bool:
        return self.routing == "shortest"

    @property
    def defection(self) -> bool:
        """Congestion-aware defection active (adaptive routing + k > 0)."""
        return self.adaptive and self.defect_after > 0


def qos_quotas(credits: int, weights: Sequence[int]) -> Tuple[int, ...]:
    """Largest-remainder split of the link credits across credit classes:
    every class gets >= 1 credit and the quotas sum to ``credits``."""
    w = np.asarray(weights, np.float64)
    raw = credits * w / w.sum()
    q = np.maximum(np.floor(raw).astype(np.int64), 1)
    while q.sum() > credits:  # trim overflow from the largest class
        q[int(np.argmax(q))] -= 1
    rem = raw - np.floor(raw)
    while q.sum() < credits:  # hand slack to the largest remainders
        i = int(np.argmax(rem))
        q[i] += 1
        rem[i] -= 1.0
    return tuple(int(x) for x in q)


def _rows(R: int, device) -> torch.Tensor:
    """(R, 1) rank index, to pair with (R, n) positions in a scatter."""
    return torch.arange(R, device=device)[:, None]


def _compact_to(valid: torch.Tensor, cap: int, *cols: torch.Tensor):
    """Per-rank stable partition: scatter the valid rows of ``(R, n, ...)``
    columns, order kept, to the front of fresh ``cap``-row buffers.  Rows
    past ``cap`` are dropped (into a trash row that is sliced off) and
    reported by the overflow flag.  Returns (valid', cols', overflow)."""
    R = valid.shape[0]
    pos = torch.where(valid, valid.cumsum(1) - 1, cap).clamp(max=cap)
    rows = _rows(R, valid.device)
    out_valid = torch.zeros((R, cap + 1), dtype=torch.bool, device=valid.device)
    out_valid[rows, pos] = valid
    outs = []
    for c in cols:
        o = torch.zeros((R, cap + 1) + c.shape[2:], dtype=c.dtype, device=c.device)
        o[rows, pos] = c
        outs.append(o[:, :cap])
    return out_valid[:, :cap], outs, valid.sum(1) > cap


class _Rx:
    """Per-rank delivery buffers, each with one trash row past ``cap``."""

    def __init__(self, R: int, cap: int, W: int, K: int, device):
        self.cap = cap
        self.frames = torch.zeros((R, cap + 1, W), dtype=torch.int32, device=device)
        self.step = torch.zeros((R, cap + 1), dtype=torch.int64, device=device)
        self.att = torch.zeros((R, cap + 1, K), dtype=torch.int64, device=device)
        self.cnt = torch.zeros(R, dtype=torch.int64, device=device)
        self.ok = torch.ones(R, dtype=torch.bool, device=device)

    def append(self, frames, take, step_no: int, att) -> None:
        """Append ``frames[take]`` rows at each rank's count, recording the
        scan step each arrived at and its attribution vector."""
        pos = torch.where(take, self.cnt[:, None] + take.cumsum(1) - 1, self.cap)
        pos = pos.clamp(max=self.cap)
        rows = _rows(take.shape[0], take.device)
        self.frames[rows, pos] = frames
        self.step[rows, pos] = step_no
        self.att[rows, pos] = att
        new_cnt = self.cnt + take.sum(1)
        self.ok &= new_cnt <= self.cap
        self.cnt = new_cnt.clamp(max=self.cap)


class Router:
    """Routed delivery of framed streams between the ranks of a grid.

    ``grid`` is the rank grid's shape (``(8,)`` for a ring of 8, ``(4, 2)``
    for the reference's ``(4, 2)`` mesh), ``axis_names`` names its axes
    (the counter and metric labels), and every tensor lives on ``device``
    (default: the CUDA card)."""

    def __init__(
        self,
        grid: Sequence[int],
        axis_names: Optional[Sequence[str]] = None,
        config: FabricConfig = FabricConfig(),
        device: DeviceLike = None,
    ):
        self.sizes = tuple(int(n) for n in grid)
        if axis_names is None:
            if len(self.sizes) != 1:
                raise ValueError(f"a {len(self.sizes)}-axis grid needs axis_names")
            axis_names = ("fabric",)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axis_names {self.axis_names} vs grid {self.sizes}")
        self.n_ranks = math.prod(self.sizes)
        err = max_ranks_error(self.n_ranks)
        if err is not None:  # same rule (and words) as Fabric.__init__
            raise ValueError(err)
        self.config = config
        self.device = default_device(device)
        #: scan steps executed, over all ticks and axes (host counter)
        self.scan_steps = 0

    # -- coordinate helpers (row-major rank <-> per-axis coords) ----------

    def _stride(self, ai: int) -> int:
        return math.prod(self.sizes[ai + 1:])

    def _coord(self, rank: torch.Tensor, ai: int) -> torch.Tensor:
        return (rank // self._stride(ai)) % self.sizes[ai]

    def _coord_int(self, rank: int, ai: int) -> int:
        return (rank // self._stride(ai)) % self.sizes[ai]

    def hops(self, src: int, dst: int) -> int:
        """Total +1-ring (dimension-order) hops from src to dst (host math)."""
        return sum(
            (self._coord_int(dst, ai) - self._coord_int(src, ai)) % n
            for ai, n in enumerate(self.sizes)
        )

    def min_hops(self, src: int, dst: int) -> int:
        """Total hops under shortest-path routing (per-axis min of the two
        ring directions)."""
        total = 0
        for ai, n in enumerate(self.sizes):
            d = (self._coord_int(dst, ai) - self._coord_int(src, ai)) % n
            total += min(d, n - d)
        return total

    def route_hops(self, src: int, dst: int) -> int:
        """Hops under THIS router's configured routing mode."""
        if self.config.adaptive:
            return self.min_hops(src, dst)
        return self.hops(src, dst)

    # -- demand-aware scan bounds -----------------------------------------

    def default_steps(self, total: int) -> Tuple[Tuple[int, int], ...]:
        """Worst-case per-axis (steps, dirs): every live frame crosses the
        busiest link and needs the full pipeline fill."""
        credits = self.config.credits
        out = []
        for n in self.sizes:
            if n == 1:
                out.append((0, 0))
                continue
            if self.config.defection:
                fill, dirs = n + self.config.defect_after, DIR_FWD | DIR_BWD
            elif self.config.adaptive:
                fill, dirs = n // 2, DIR_FWD | DIR_BWD
            else:
                fill, dirs = n, DIR_FWD
            out.append((-(-total // credits) + fill + 1, dirs))
        return tuple(out)

    def plan_steps(
        self,
        srcs: Sequence[int],
        dsts: Sequence[int],
        counts: Sequence[int],
    ) -> Tuple[Tuple[int, int], ...]:
        """Per-axis (scan steps, direction mask) from the tick's ACTUAL
        demand, host math only: the analyzer's load matrix
        (``analysis.comm.demand_link_loads``) turned into bounds by
        ``bounds_from_loads``, capped by :meth:`default_steps`."""
        from ..analysis.comm import bounds_from_loads, demand_link_loads

        defect = self.config.defect_after if self.config.defection else 0
        loads = demand_link_loads(
            self.sizes, srcs, dsts, counts, self.config.adaptive
        )
        return bounds_from_loads(
            loads, self.sizes, self.config.credits, defect,
            self.default_steps(sum(counts)),
        )

    def bucket_total(self, total_frames: Optional[int], T: int) -> int:
        """Pow2-bucket the live-frame bound (the reference's jit-cache
        bucketing; it sizes the queues, so the port keeps it)."""
        R = self.n_ranks
        total = min(total_frames or R * T, R * T)
        if total < R * T:
            total = min(1 << max(total - 1, 0).bit_length(), R * T)
        return total

    def _capacities(self, T: int, total: int) -> Tuple[int, int]:
        """(rx_cap, q_cap) for a tick of ``total`` live frames and per-rank
        TX depth ``T`` — one derivation shared by both engines."""
        cfg = self.config
        rx_cap = cfg.rx_frames or min(self.n_ranks * T, total)
        arrivals = cfg.credits * (2 if cfg.adaptive else 1)
        return rx_cap, max(total, T) + arrivals

    # -- delivery ----------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        """numpy (u32 words, ints, bools) or tensor -> tensor on the device;
        u32 words become int32 lanes."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    def deliver(self, tx, tx_valid, total_frames: Optional[int] = None):
        """Route every valid tx frame to its destination rank.

        ``tx`` is ``(ranks, T, width)`` (int32 lanes, or u32 numpy),
        ``tx_valid`` ``(ranks, T)`` bool.  ``total_frames`` bounds the
        valid frames across all ranks (default ``R*T``); the scan bound
        derives from it.  Returns ``(rx, rx_count, ok, crc_ok, rx_step,
        rx_att, counters)`` per rank, as the reference: delivered frames in
        arrival order, counts, a routing flag (False on undeliverable
        frames or overflow), a CRC flag, the scan step each frame arrived
        at, the per-frame attribution (``obs.counters`` ``ATT_*`` layout:
        ``wait + stall + sum(transit) == rx_step`` per frame) and the
        telemetry counter block (``obs.counters`` layout).
        """
        tx, tx_valid = self._tensor(tx), self._tensor(tx_valid)
        R, T, W = tx.shape
        if R != self.n_ranks or W != self.config.frame_width:
            raise ValueError(
                f"tx shape {tuple(tx.shape)} vs ranks={self.n_ranks}, "
                f"width={self.config.frame_width}"
            )
        total = self.bucket_total(total_frames, T)
        rx_cap, q_cap = self._capacities(T, total)
        return self._route(tx, tx_valid, self.default_steps(total), q_cap, rx_cap)

    def _route(self, tx, tx_valid, axis_steps, q_cap: int, rx_cap: int):
        """The routing program over the rank axis: self-sends, then an
        inject/hop/deliver scan per axis, then the CRC check.

        ``axis_steps`` is a static (steps, direction-mask) per axis.  A
        0-step axis is skipped; a direction absent from the mask moves no
        link buffer.
        """
        cfg = self.config
        W = cfg.frame_width
        credits = cfg.credits
        n_axes = len(self.axis_names)
        R, T, _ = tx.shape
        dev = tx.device
        quotas = qos_quotas(credits, cfg.qos_weights) if cfg.qos_weights else None
        K = n_att(n_axes)
        IDX_DELIVERED = global_index(n_axes, "delivered")
        IDX_CRC_FAIL = global_index(n_axes, "crc_fail")

        def select(levels, elig):
            """Pick one direction's link occupants: FIFO, or weighted
            round-robin over ListLevel credit classes (quota a class
            leaves unused spills to the others).  Also returns the frames
            admitted via the spill, per rank."""
            if quotas is None:
                return elig & (elig.cumsum(1) <= credits), torch.zeros(
                    R, dtype=torch.int64, device=dev)
            cls = (levels.to(torch.int64) & 0xFFFFFFFF) % len(quotas)
            take = torch.zeros_like(elig)
            for c, qc in enumerate(quotas):
                in_c = elig & (cls == c)
                take = take | (in_c & (in_c.cumsum(1) <= qc))
            rest = elig & ~take
            spill = credits - take.sum(1, keepdim=True)
            spilled = rest & (rest.cumsum(1) <= spill)
            return take | spilled, spilled.sum(1)

        def hop(queue, take, ai, shift, att, extra=None):
            """Scatter one direction's occupants into the link buffer and
            move it one hop along axis ``ai`` (a roll of the rank grid).
            The valid flag, the attribution vector and — with defection —
            the direction commitment ride as trailing columns of the same
            buffer."""
            E = 2 if extra is not None else 1
            pos = torch.where(take, take.cumsum(1) - 1, credits).clamp(max=credits)
            cols = [queue, take.to(torch.int32)[..., None]]
            if extra is not None:
                cols.append(extra.to(torch.int32)[..., None])
            cols.append(att.to(torch.int32))
            buf = torch.cat(cols, dim=-1)
            link = torch.zeros((R, credits + 1, buf.shape[-1]), dtype=torch.int32,
                               device=dev)
            link[_rows(R, dev), pos] = buf
            grid = link[:, :credits].reshape(self.sizes + (credits, buf.shape[-1]))
            arr = torch.roll(grid, shifts=shift, dims=ai).reshape(R, credits, -1)
            adir = arr[..., W + 1].to(torch.int64) if extra is not None else None
            return (arr[..., :W], arr[..., W] != 0, adir,
                    arr[..., W + E:].to(torch.int64))

        ranks = torch.arange(R, device=dev)
        me = ranks[:, None]
        queue = torch.nn.functional.pad(tx, (0, 0, 0, q_cap - T))
        qvalid = torch.nn.functional.pad(tx_valid, (0, q_cap - T))
        rx = _Rx(R, rx_cap, W, K, dev)
        step_no = 0
        # telemetry counter block: every field is an order-independent
        # EVENT count, so both engines agree bit for bit
        ctr = torch.zeros((R, n_counters(n_axes)), dtype=torch.int64, device=dev)
        # per-frame flight recorder, one vector per queue row
        qatt = torch.zeros((R, q_cap, K), dtype=torch.int64, device=dev)

        # self-sends never cross a link: delivered up front (step 0)
        self_take = qvalid & (route_dst(queue) == me)
        rx.append(queue, self_take, step_no, qatt)
        ctr[:, IDX_DELIVERED] += self_take.sum(1)
        qvalid = qvalid & ~self_take

        for ai in range(n_axes):
            n_axis = self.sizes[ai]
            steps, dirs = axis_steps[ai]
            if n_axis == 1 or steps == 0:
                continue
            myc = self._coord(ranks, ai)[:, None]
            half = n_axis // 2
            use_fwd = bool(dirs & DIR_FWD)
            use_bwd = bool(dirs & DIR_BWD)
            defect = cfg.defect_after if (cfg.defection and use_fwd and use_bwd) else 0
            # per-frame scheduling keys, carried with the queue
            qdst = self._coord(route_dst(queue), ai)
            qlvl = queue[..., HDR_LEVEL]
            qadp = route_adaptive(queue)
            qsrc = self._coord(route_src(queue), ai)
            qdir = torch.zeros((R, q_cap), dtype=torch.int64, device=dev)
            sf = torch.zeros(R, dtype=torch.int64, device=dev)
            sb = torch.zeros(R, dtype=torch.int64, device=dev)
            ix_f = {f: ctr_index(ai, 0, f) for f in _CTR_FIELDS}
            ix_b = {f: ctr_index(ai, 1, f) for f in _CTR_FIELDS}

            it, more = 0, True
            while it < steps and more:
                it += 1
                step_no += 1
                fwd = (qdst - myc) % n_axis
                elig = qvalid & (fwd != 0)
                prefer_bwd = qadp & (fwd > half) if use_bwd else torch.zeros_like(elig)
                go_bwd = torch.where(qdir == 0, prefer_bwd, qdir == 2) if defect else prefer_bwd
                if use_fwd:
                    take_f, spill_f = select(qlvl, elig & ~go_bwd)
                if use_bwd:
                    take_b, spill_b = select(qlvl, elig & go_bwd)
                if defect:
                    # per-(link, direction) starvation this step
                    starved_f = (elig & ~go_bwd & ~take_f).any(1)
                    starved_b = (elig & go_bwd & ~take_b).any(1)
                    # defectors: uncommitted adaptive frames whose preferred
                    # link starved `defect` straight steps, admitted only
                    # into the OPPOSITE direction's spare credits
                    can_b = (elig & ~go_bwd & ~take_f & qadp & (qdir == 0)
                             & (sf[:, None] >= defect))
                    extra_b = can_b & (can_b.cumsum(1)
                                       <= credits - take_b.sum(1, keepdim=True))
                    can_f = (elig & go_bwd & ~take_b & qadp & (qdir == 0)
                             & (sb[:, None] >= defect))
                    extra_f = can_f & (can_f.cumsum(1)
                                       <= credits - take_f.sum(1, keepdim=True))
                    take_f = take_f | extra_f
                    take_b = take_b | extra_b
                    # the commitment travels with the frame
                    qdir = torch.where(extra_b, 2, torch.where(extra_f, 1, qdir))
                    sf = torch.where(starved_f, sf + 1, 0)
                    sb = torch.where(starved_b, sb + 1, 0)
                    ctr[:, ix_f["defect_out"]] += extra_b.sum(1)
                    ctr[:, ix_b["spare_in"]] += extra_b.sum(1)
                    ctr[:, ix_b["defect_out"]] += extra_f.sum(1)
                    ctr[:, ix_f["spare_in"]] += extra_f.sum(1)
                # per-direction telemetry: pure event counts over demand
                # and takes (`entered` only at a frame's first hop on the
                # axis; `occupied`/`starved` as per-step demand booleans)
                taken = torch.zeros_like(qvalid)
                for use, take, spill, el, ix in (
                    (use_fwd, take_f if use_fwd else None, spill_f if use_fwd else None,
                     elig & ~go_bwd, ix_f),
                    (use_bwd, take_b if use_bwd else None, spill_b if use_bwd else None,
                     elig & go_bwd, ix_b),
                ):
                    if not use:
                        continue
                    ctr[:, ix["entered"]] += (take & (qsrc == myc)).sum(1)
                    ctr[:, ix["forwarded"]] += take.sum(1)
                    ctr[:, ix["spilled"]] += spill
                    ctr[:, ix["occupied"]] += el.any(1)
                    ctr[:, ix["starved"]] += (el & ~take).any(1)
                    taken = taken | take
                # flight recorder, BEFORE the hops and against the
                # step-start qvalid: taken / stalled / waiting are disjoint
                # and cover every live queued frame
                enter = qatt[..., ATT_ENTER]
                qatt[..., ATT_ENTER] = torch.where(taken & (enter == 0), step_no, enter)
                qatt[..., N_ATT_FIXED + ai] += taken
                qatt[..., ATT_STALL] += elig & ~taken
                qatt[..., ATT_WAIT] += qvalid & ~elig
                if defect:
                    qatt[..., ATT_DEFECT] += extra_b | extra_f
                arrs, avalids, adirs, aatts = [], [], [], []
                ex = qdir if defect else None
                for use, take, shift in ((use_fwd, take_f if use_fwd else None, 1),
                                         (use_bwd, take_b if use_bwd else None, -1)):
                    if not use:
                        continue
                    a, av, ad, aa = hop(queue, take, ai, shift, qatt, extra=ex)
                    qvalid = qvalid & ~take
                    arrs.append(a)
                    avalids.append(av)
                    adirs.append(ad)
                    aatts.append(aa)
                arr = torch.cat(arrs, 1)
                avalid = torch.cat(avalids, 1)
                aatt = torch.cat(aatts, 1)
                # deliver frames that reached their full destination
                done = avalid & (route_dst(arr) == me)
                rx.append(arr, done, step_no, aatt)
                ctr[:, IDX_DELIVERED] += done.sum(1)
                # transit frames re-queue at the FRONT (FIFO per path)
                cols = [
                    torch.cat([arr, queue], 1),
                    torch.cat([self._coord(route_dst(arr), ai), qdst], 1),
                    torch.cat([arr[..., HDR_LEVEL], qlvl], 1),
                    torch.cat([route_adaptive(arr), qadp], 1),
                    torch.cat([self._coord(route_src(arr), ai), qsrc], 1),
                    torch.cat([aatt, qatt], 1),
                ]
                if defect:
                    cols.append(torch.cat([torch.cat(adirs, 1), qdir], 1))
                qvalid, outs, over = _compact_to(
                    torch.cat([avalid & ~done, qvalid], 1), q_cap, *cols)
                queue, qdst, qlvl, qadp, qsrc, qatt = outs[:6]
                if defect:
                    qdir = outs[6]
                rx.ok &= ~over
                if cfg.early_exit:
                    # global: every rank agrees on the trip count
                    more = bool((qvalid & (((qdst - myc) % n_axis) != 0)).any())
            self.scan_steps += it

        # anything still queued is undeliverable (bad dst / starved link)
        ok = rx.ok & ~qvalid.any(1)
        frames = rx.frames[:, :rx_cap]
        live = torch.arange(rx_cap, device=dev) < rx.cnt[:, None]
        frame_crc = verify_frames(frames)
        crc_ok = torch.where(live, frame_crc, True).all(1)
        ctr[:, IDX_CRC_FAIL] += (live & ~frame_crc).sum(1)
        return (frames, rx.cnt, ok, crc_ok, rx.step[:, :rx_cap].to(torch.int32),
                rx.att[:, :rx_cap].to(torch.int32), ctr.to(torch.int32))

    # -- fused tick ----------------------------------------------------------

    def deliver_fused(
        self,
        payloads: np.ndarray,  # (R, Bmax, Wcap) u32 — sends grouped by src
        nbytes: np.ndarray,  # (R, Bmax) int32 true byte lengths
        routes: np.ndarray,  # (R, Bmax, 3) int32 (src, dst, seq0)
        levels: np.ndarray,  # (R, Bmax) uint32 per-send ListLevels
        send_valid: np.ndarray,  # (R, Bmax) bool — real send vs padding row
        axis_steps: Tuple[Tuple[int, int], ...],
        total: int,
        faults: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    ):
        """One fused tick: frame every rank's sends (structure pass + the
        ``pack_frames_batch`` kernel), lay the live frames out as that
        rank's TX queue, run the routed scan, and split the delivered
        frames with the ``unpack_frames_batch`` kernel — frames stay on
        the device throughout.

        ``faults`` is ``(gather (R, T) int32, xor (R, T, W) u32, valid
        (R, T) bool)``: after framing each rank's TX queue becomes
        ``tx[gather] ^ xor`` with ``valid`` as the post-fault liveness.

        Returns ``(rx_hdr (R, cap, HDR_WORDS), rx_pay (R, cap,
        frame_words), rx_cnt, ok, crc_ok, rx_step, rx_att, counters)``.
        """
        from ..kernels.frame_pack import pack_frames_batch, unpack_frames_batch
        from .frames import frame_parts_batch

        cfg = self.config
        W = cfg.frame_width
        frame_words = cfg.frame_phits * PHIT_WORDS
        R, Bmax, Wcap = payloads.shape
        F = Wcap // frame_words + 1  # + terminator
        T = Bmax * F  # a rank's TX queue is exactly its own frames
        rx_cap, q_cap = self._capacities(T, total)
        nb = self._tensor(nbytes).to(torch.int64)
        hdr, data, _ = frame_parts_batch(
            self._tensor(payloads).reshape(R * Bmax, Wcap), nb.reshape(-1),
            self._tensor(routes).reshape(R * Bmax, 3),
            list_level=self._tensor(levels.astype(np.int64)).reshape(-1),
            frame_phits=cfg.frame_phits, adaptive=cfg.adaptive,
        )
        tx = pack_frames_batch(hdr, data).reshape(R, T, W)
        # frame f of send i is live iff f < frame_capacity(nbytes_i)
        n_live = (nb + 3) // 4
        n_live = (n_live + frame_words - 1) // frame_words + 1
        fidx = torch.arange(F, device=self.device)
        tx_valid = (self._tensor(send_valid)[..., None]
                    & (fidx < n_live[..., None])).reshape(R, T)
        if faults is not None:
            # the post-fault queue is a gather of the canonical rows (drop,
            # duplicate, reorder) XOR a corruption mask
            gather, xor, fvalid = (self._tensor(f) for f in faults)
            tx = torch.gather(tx, 1, gather.to(torch.int64)[..., None].expand(-1, -1, W)) ^ xor
            tx_valid = fvalid
        rx, rx_cnt, ok, crc_ok, rx_step, rx_att, ctr = self._route(
            tx, tx_valid, axis_steps, q_cap, rx_cap)
        rx_hdr, rx_pay = unpack_frames_batch(rx.reshape(R * rx_cap, W))
        return (rx_hdr.reshape(R, rx_cap, HDR_WORDS),
                rx_pay.reshape(R, rx_cap, frame_words),
                rx_cnt, ok, crc_ok, rx_step, rx_att, ctr)
