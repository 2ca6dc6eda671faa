"""Whole-message send/recv over the routed fabric, on one card.

Counterpart of the reference's ``fabric/mailbox.py``: the host half (seq
bookkeeping, reassembly, ARQ, fault planning, counter folds) is the
reference's numpy code; the device half is the port's :class:`Router`,
whose ranks are rows of one tensor on one device.

* ``Mailbox.send(dst, wire)`` queues a whole serialized HGum message for
  any rank.  At :meth:`Fabric.exchange` time every pending send across all
  ranks is framed in ONE batched SER pass, routed by the router (multi-hop,
  credit flow control), and reassembled here.  By default framing, routing
  and the RX split run as one fused call (``Router.deliver_fused``, which
  launches the ``pack_frames_batch`` and ``unpack_frames_batch`` kernels);
  with ``FabricConfig(fused=False)`` or a ``tx_hook`` the three-stage
  engine runs instead (``kernels.ops.encode_frames_batch`` + host scatter
  + ``Router.deliver`` + ``kernels.ops.decode_frames_batch``).
* ``Mailbox.recv()`` drains delivered messages as :class:`Delivery`
  records.  The receiver re-orders each source's frames by the route
  word's ``seq`` (wrap-aware) and cuts messages at the empty end-of-list
  terminator frames (paper §IV-C).
* every delivered frame is CRC32-checked twice: on the device by the
  router (``crc_ok``) and here per message, so one corrupt frame flags
  exactly the message it belongs to.

Two tick styles: :meth:`Fabric.exchange` (frame, route and reassemble
before returning) and :meth:`Fabric.exchange_async` + :meth:`Fabric.poll`
(depth-1 double buffer: the RX readback and reassembly wait for the next
``poll``; per-(src, dst) order is kept).  In eager torch the early-exit
router scan syncs with the host once per scan step, so the dispatch half
is not free of host syncs as the reference's is.  On the card the fused
tick ends by copying its outputs into pinned host buffers without blocking
and recording an event; ``poll`` waits on that event only, not on work
queued on the stream after the tick (the next decode step of a streaming
serve), which is how the reference's overlap works on this card.

Reliable delivery (``FabricConfig.arq=True``): senders keep every data
message in a bounded per-(src, dst) retransmit buffer keyed by the route
word's seq; receivers CRC-filter delivered frames, buffer out-of-order
survivors in a seq window, and answer gaps with NACK and progress with
cumulative-ACK control frames (magic-tagged single-frame records on QoS
class ``arq_level``).  Senders retransmit on NACK or on a tick-count
timeout with capped exponential backoff and dead-letter after
``max_retries``; duplicates are suppressed by the seq window.  A gap that
outlives ``skip_after`` ticks is flagged (``ok=False``) and resynced past.
With ``arq=False`` (default) all of this is off: flag-only delivery.

Not ported yet (ROADMAP item 11): the static analyzer hooks
(``analyze=True``), the trace timeline (``trace=``) and request spans.
The reference's per-bucket recompile log has no counterpart: eager torch
compiles nothing per tick shape.
"""
from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.rules import list_level_error, max_ranks_error
from ..device import DeviceLike
from ..obs.counters import (
    CTR_FIELDS,
    DIR_SLOTS,
    FrameAttribution,
    ctr_index,
    global_index,
    load_drift as _load_drift,
    n_att,
    n_counters,
    observed_link_loads as _observed_link_loads,
)
from ..obs.metrics import ClassWindows, MetricsRegistry
from .faults import FaultPlan
from .frames import (
    HDR_CRC,
    HDR_LEVEL,
    HDR_ROUTE,
    HDR_SIZE,
    HDR_WORDS,
    PHIT_WORDS,
    SEQ_MOD,
    frame_capacity,
)
from ..core.vectorized import lanes_u32
from ..kernels.ops import decode_frames_batch, encode_frames_batch
from .router import FabricConfig, Router

#: magic word opening every ARQ control record ("ARQ1"), so a control
#: frame is self-describing: no reassembly, no ordering, each payload
#: frame parsed independently
ARQ_MAGIC = 0x41525131
ARQ_ACK = 1
ARQ_NACK = 2

#: fabric.arq.* counter catalog (materialized at init and every tick so
#: zero-fault runs still export the full set for the SLO evaluator —
#: `max_retransmit_ratio` must see 0, not an absent signal)
ARQ_COUNTERS = (
    "retransmits", "nacks", "acks", "dup_suppressed", "timeouts",
    "crc_dropped", "aborts", "evicted", "replays", "skips",
)


class FabricCorruption(RuntimeError):
    """Raised by ``drain(on_corrupt="raise")`` when a drained delivery is
    corrupt (CRC failure or seq gap the ARQ layer could not repair).  The
    inbox is left INTACT so the caller can re-drain with ``"flag"`` and
    inspect the damage."""


@dataclass
class Delivery:
    """One reassembled message: who sent it, its wire bytes, CRC verdict,
    the ListLevel its frames carried (paper §IV-C; senders can use it to
    tag streams, e.g. MoE expert ids or QoS tenant classes), and the router
    scan step its last frame arrived at (in-tick queueing latency — the
    observable the QoS credit classes bound).

    ``attribution`` is the flight-recorder vector of the message's
    *critical* frame (the one that arrived last): queue wait + credit
    stall + per-axis transit + defections, with ``attribution.arrive_step
    == arrive_step`` exactly.  ``request_id`` is the span id the sender
    attached (``Fabric.send(request_id=...)``), correlated back through
    the route word's ``(src, dst, seq)`` range — None for untracked
    sends."""

    src: int
    wire: bytes
    ok: bool = True
    list_level: int = 1
    arrive_step: int = 0
    attribution: Optional[FrameAttribution] = None
    request_id: Optional[int] = None
    #: route-word seq of the message's first frame — the key
    #: ``drain(on_corrupt="retry")`` uses to find the sender's buffered
    #: copy for a replay
    seq0: Optional[int] = None


@dataclass
class _PartialMsg:
    data: bytearray = field(default_factory=bytearray)
    ok: bool = True
    level: int = 1
    step: int = 0
    #: attribution row of the latest-arriving frame folded in so far
    att: Optional[np.ndarray] = None
    #: route-word seq of the message's first frame (rid correlation key)
    seq0: Optional[int] = None


def _wire_words(wire: bytes, cap_words: int) -> np.ndarray:
    buf = np.frombuffer(wire, np.uint8)
    pad = cap_words * 4 - len(buf)
    return np.concatenate([buf, np.zeros(pad, np.uint8)]).view(np.uint32)


class Fabric:
    """A routed message fabric over a rank grid on one device (host side).

    The rank count is explicit.  The reference's ``Fabric(n_ranks=None)``
    means one rank per JAX device; on one card the ranks are rows of one
    tensor, so there is no device count to default to.  Pass either
    ``n_ranks`` (a ring of that many ranks, axis ``"fabric"``) or ``grid``
    with ``axis_names`` (a multi-axis rank grid, e.g. ``(4, 2)`` for the
    reference's ``(4, 2)`` mesh), not both.  Tensors live on ``device``
    (default: the CUDA card; ``device="cpu"`` runs on the host).
    """

    def __init__(
        self,
        grid: Optional[Sequence[int]] = None,
        axis_names: Optional[Sequence[str]] = None,
        config: FabricConfig = FabricConfig(),
        n_ranks: Optional[int] = None,
        analyze: bool = False,
        metrics: Optional[MetricsRegistry] = None,
        trace=None,
        device: DeviceLike = None,
    ):
        if (grid is None) == (n_ranks is None):
            raise ValueError(
                "pass n_ranks (a ring) or grid (a rank grid), exactly one: on "
                "one card the rank count cannot default to the device count"
            )
        if analyze or trace is not None:
            raise NotImplementedError(
                "Fabric(analyze=True) and trace= wait for the port of the "
                "analyzer passes and the trace export (ROADMAP item 11)"
            )
        if grid is None:
            err = max_ranks_error(n_ranks)
            if err is not None:  # the route-word explanation, before any tensor
                raise ValueError(err)
            grid = (n_ranks,)
        self.router = Router(grid, axis_names, config, device)
        self.config = config
        R = self.router.n_ranks
        self._pending: List[Tuple[int, int, bytes, int]] = []  # (src, dst, wire, level)
        #: per-send metadata parallel to `_pending` (a separate list so
        #: every consumer of the 4-tuples — analyze_sends, the dispatchers
        #: — keeps its shape): {"rid": span id or None, "seq0": pinned seq
        #: for an ARQ retransmit (None = assign fresh), "ctl": ARQ
        #: control frame}.  The in-flight rid->seq-range table
        #: {(dst, src): [(seq0, n_frames, rid), ...]} is matched back at
        #: reassembly through the route word.
        self._pending_meta: List[dict] = []
        self._send_spans: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        # seq counters are per (src, dst) stream so a receiver's expected
        # base never lags: every frame of the (src -> me) stream lands here,
        # keeping the u16 wrap window exact.
        self._tx_seq = [[0] * R for _ in range(R)]  # [src][dst] next seq
        self._rx_seq = [[0] * R for _ in range(R)]  # [rank][src] expected seq
        self._partial = [[_PartialMsg() for _ in range(R)] for _ in range(R)]
        self._inbox: List[List[Delivery]] = [[] for _ in range(R)]
        #: per-(rank, QoS class) trace of recent Delivery.arrive_steps —
        #: the congestion observable the stream plane's backpressure-fed
        #: lane scheduler consumes (class = list_level % n_classes, the
        #: same key the router's WRR credit scheduler uses).  ONE shared
        #: windowing implementation (obs.metrics) with the StreamReader.
        self._arrive: List[ClassWindows] = [
            ClassWindows(maxlen=256) for _ in range(R)
        ]
        #: host-side telemetry: always-on metrics registry (pass one in to
        #: share it with the serve loop)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        #: on-device counter folds (obs.counters layout): all-time per-rank
        #: totals plus a window of per-tick deltas, and the accumulated
        #: STATIC demand matrix of every dispatched tick — the expected
        #: side of the static-vs-observed load drift check
        NC = n_counters(len(self.router.axis_names))
        self._ctr_total = np.zeros((R, NC), np.int64)
        self._ctr_window: deque = deque(maxlen=256)
        self._expected_loads: List[Dict[Tuple, int]] = [
            {} for _ in self.router.sizes
        ]
        #: the dispatched-but-not-reassembled tick (device tensors + counts)
        self._inflight: Optional[Tuple] = None
        self.frames_routed = 0
        self.exchanges = 0
        #: fault-injection hook for tests/chaos: (tx, tx_valid) -> tx, applied
        #: after framing and before routing (simulates link corruption).
        #: Legacy three-program-only hook; prefer ``faults`` below.
        self.tx_hook = None
        #: seeded chaos plan (``fabric.faults.FaultPlan``) applied to BOTH
        #: tick engines at the same logical point: after framing, before
        #: the routed scan.  Fault decisions key on the dispatch count
        #: (``self.exchanges``), so fused and three-program runs of the
        #: same send sequence see identical faults.
        self.faults: Optional[FaultPlan] = None
        #: device-side CRC verdict of the last exchange (router `crc_ok`)
        self.last_crc_ok = True
        #: virtual clock: +1 on EVERY exchange_async call (even idle ones)
        #: — the time base of the ARQ timeouts and the serve plane's
        #: blackout detector
        self.ticks = 0
        # -- ARQ state (inert unless config.arq) --------------------------
        #: control frames use their own per-(src, dst) seq counters so
        #: loss-tolerant ctl traffic never perturbs the data seq window
        self._tx_seq_ctl = [[0] * R for _ in range(R)]
        #: sender retransmit buffers: {(src, dst): deque of entries
        #: {seq0, n, wire, level, rid, last_tx, retries}} bounded by
        #: config.arq_buffer frames (oldest evicted to the dead letters)
        self._retx: Dict[Tuple[int, int], deque] = {}
        #: dead letters: messages the ARQ gave up on (max_retries
        #: exceeded or evicted) — kept for `drain(on_corrupt="retry")`
        self._dead: deque = deque(maxlen=64)
        #: receiver out-of-order window: [rank][src] {seq: (size, level,
        #: payload_row, step, att)} of CRC-clean frames ahead of expected
        self._ooo: List[List[Dict[int, Tuple]]] = [
            [{} for _ in range(R)] for _ in range(R)
        ]
        #: [rank][src] tick a seq gap was first seen (None = no gap) —
        #: drives NACK re-sends and the skip_after give-up horizon
        self._gap_since: List[List[Optional[int]]] = [
            [None] * R for _ in range(R)
        ]
        self._last_nack = [[-(1 << 30)] * R for _ in range(R)]
        #: [rank][src] in-order progress not yet cumulative-ACKed
        self._ack_owed = [[False] * R for _ in range(R)]
        self._last_ack = [[-(1 << 30)] * R for _ in range(R)]
        #: [rank][src] last tick anything (data or ctl) arrived from src —
        #: the serve plane's suspect/blackout signal
        self._last_heard: List[List[Optional[int]]] = [
            [None] * R for _ in range(R)
        ]
        #: (rank, src, seq0) replays already issued by on_corrupt="retry"
        #: (one replay per corrupt message, never a loop)
        self._replayed: set = set()
        if config.arq:
            self._materialize_arq_counters()

    @property
    def n_ranks(self) -> int:
        return self.router.n_ranks

    def mailbox(self, rank: int) -> "Mailbox":
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"rank {rank} outside fabric of {self.n_ranks}")
        return Mailbox(self, rank)

    # -- send side ---------------------------------------------------------

    def send(self, src: int, dst: int, wire: bytes, list_level: int = 1,
             request_id: Optional[int] = None) -> None:
        """Queue ``wire`` for routed delivery ``src -> dst``.

        ``request_id`` tags the message with a span id (obs.spans): the
        receiver's :class:`Delivery` carries it back, correlated through
        the route word's ``(src, dst, seq)`` range, so one request renders
        as a connected arc across ranks.

        Arguments are validated HERE, with clear errors, rather than
        surfacing as shape mismatches or routing failures deep inside the
        router scan at exchange time.
        """
        if not 0 <= dst < self.n_ranks:
            raise ValueError(f"dst {dst} outside fabric of {self.n_ranks}")
        if not 0 <= src < self.n_ranks:
            raise ValueError(f"src {src} outside fabric of {self.n_ranks}")
        if not isinstance(wire, (bytes, bytearray, memoryview)):
            raise ValueError(
                f"wire must be bytes-like, got {type(wire).__name__}"
            )
        if len(wire) == 0:
            raise ValueError(
                "empty wire: zero-length sends carry no payload frames and "
                "cannot be distinguished from a bare end-of-message "
                "terminator — serialize an empty List instead"
            )
        err = list_level_error(list_level)
        if err is not None:
            # shared analyzer rule fabric-list-level: the ListLevel header
            # lane is u8-budgeted; an out-of-range level would wrap
            # silently and alias another tenant's QoS class (the router
            # keys credit classes on level % n_classes)
            raise ValueError(err)
        if self.config.arq and int(list_level) == self.config.arq_level:
            raise ValueError(
                f"list_level {list_level} is reserved for ARQ ACK/NACK "
                f"control frames while arq=True — pick another level (or "
                f"move FabricConfig.arq_level)"
            )
        self._pending.append((src, dst, bytes(wire), int(list_level)))
        self._pending_meta.append({
            "rid": int(request_id) if request_id is not None else None,
            "seq0": None, "ctl": False,
        })

    def _send_ctl(self, src: int, dst: int, kind: int, ack_seq: int) -> None:
        """Queue one ARQ control record ``src -> dst``: a single-frame,
        self-contained ``[MAGIC, kind, ack_seq, 0]`` payload riding the
        reserved ``arq_level`` QoS class.  Control frames are idempotent
        and loss-tolerant (timeouts re-derive anything a lost ACK/NACK
        carried), so they are never ARQ-buffered themselves."""
        payload = np.array(
            [ARQ_MAGIC, kind, ack_seq, 0], np.uint32
        ).tobytes()
        self._pending.append((src, dst, payload, self.config.arq_level))
        self._pending_meta.append({"rid": None, "seq0": None, "ctl": True})

    # -- the fabric tick ---------------------------------------------------

    def exchange(self) -> None:
        """Frame, route, and deliver every pending send (one fabric tick).

        Synchronous: completes any in-flight async tick first, then blocks
        until this tick's messages are reassembled into the inboxes.
        """
        self.exchange_async()
        self.poll()

    def exchange_async(self) -> bool:
        """Dispatch one fabric tick without waiting for delivery.

        Frames every pending send and launches the router scan; device work
        proceeds in the background (JAX async dispatch) while the host
        returns immediately.  Call :meth:`poll` to reassemble the tick's
        messages into the inboxes.  Depth-1 double buffer: a previous
        in-flight tick is completed first, so per-stream FIFO order holds.
        Returns True when a tick was dispatched (False: nothing pending).
        """
        if self._inflight is not None:
            self._complete()
        # virtual clock: advances on every call (idle ticks included) so
        # ARQ timeouts and the serve plane's blackout detector measure
        # elapsed fabric time, not message counts
        self.ticks += 1
        if self.config.arq:
            # may queue retransmits (sender timeouts), re-NACKs, owed
            # ACKs, and gap skips into _pending — BEFORE the empty check,
            # so recovery traffic flows even when the app has nothing to
            # say
            self._arq_tick()
        if not self._pending:
            return False
        sends, self._pending = self._pending, []
        metas, self._pending_meta = self._pending_meta, []
        if len(metas) != len(sends):  # a test poked _pending directly
            metas = (metas + [{}] * len(sends))[: len(sends)]
        phits = self.config.frame_phits
        frame_words = phits * PHIT_WORDS
        B = len(sends)
        n_live = [frame_capacity(len(w), phits) for _, _, w, _ in sends]
        # bucket the payload frame capacity (pow2), as the reference does
        # for jit reuse: the buckets size the TX rows and queues, so the
        # port keeps them and its ticks match the reference's
        pf = 1 << max(max(n_live) - 2, 0).bit_length()  # payload frames
        cap_words = pf * frame_words
        F_arr = pf + 1  # + terminator: frames emitted per stream
        payloads = np.stack([_wire_words(w, cap_words) for _, _, w, _ in sends])
        nbytes = np.asarray([len(w) for _, _, w, _ in sends], np.int32)
        routes = np.zeros((B, 3), np.int32)
        for i, (src, dst, _, _) in enumerate(sends):
            m = metas[i]
            if m.get("ctl"):
                # control frames: own seq space, never buffered, never
                # span-correlated (each ctl payload frame is parsed
                # standalone by magic — the receiver ignores ctl seqs)
                seq0 = self._tx_seq_ctl[src][dst]
                self._tx_seq_ctl[src][dst] = (seq0 + n_live[i]) % SEQ_MOD
                routes[i] = (src, dst, seq0)
                continue
            if m.get("seq0") is not None:
                # ARQ retransmit: the message keeps its ORIGINAL seq range
                # (no counter advance, no re-registration — the original
                # retx entry and span registration still stand)
                routes[i] = (src, dst, int(m["seq0"]))
                continue
            seq0 = self._tx_seq[src][dst]
            routes[i] = (src, dst, seq0)
            self._tx_seq[src][dst] = (seq0 + n_live[i]) % SEQ_MOD
            if self.config.arq:
                self._retx_register(src, dst, seq0, n_live[i], sends[i][2],
                                    sends[i][3], m.get("rid"))
            if m.get("rid") is not None:
                # rid correlation: the message owns seqs [seq0, seq0+n) of
                # the (src -> dst) stream; reassembly matches the first
                # delivered frame's seq into this range
                self._send_spans.setdefault((dst, src), []).append(
                    (seq0, n_live[i], m["rid"])
                )

        # accumulate the tick's STATIC demand matrix (what the analyzer
        # predicts this traffic should put on every (link, direction)) so
        # `load_drift()` can hold it against the on-device observed side
        self._note_expected(sends, n_live)
        # seeded chaos: ONE post-fault frame list per rank, consumed by
        # whichever engine dispatches below — injection dynamics are
        # engine-independent by construction
        fault_lists = self._plan_frame_faults(sends, n_live, routes)
        if self.config.fused and self.tx_hook is None:
            self._dispatch_fused(sends, n_live, payloads, nbytes, routes,
                                 F_arr, fault_lists)
        else:
            fill = [0] * self.n_ranks
            if fault_lists is not None:
                for r, post in enumerate(fault_lists):
                    fill[r] = len(post)
            else:
                for i, (src, _, _, _) in enumerate(sends):
                    fill[src] += n_live[i]
            T = max(1, max(fill))
            T = 1 << (T - 1).bit_length()  # the reference's pow2 TX bucket
            total = self.router.bucket_total(sum(fill), T)
            self._dispatch_programs(
                sends, n_live, payloads, nbytes, routes, T, total,
                pf, frame_words, fault_lists,
            )
        self.exchanges += 1
        return True

    def _plan_frame_faults(self, sends, n_live, routes):
        """Roll the seeded :class:`FaultPlan` over this tick's logical
        frames.  Returns per-rank POST-fault frame lists ``[(send_i,
        frame_idx, xor_word, xor_val), ...]`` in transmit order (a dropped
        frame is absent, a duplicated one appears twice, a reordered rank
        is permuted), or None when no plan is active.  Both engines
        consume exactly this list, so the same seed produces the same
        faults — and the same recovery — on either path."""
        plan = self.faults
        if plan is None or not plan.active:
            return None
        out = []
        for r in range(self.n_ranks):
            idxs = [i for i, s in enumerate(sends) if s[0] == r]
            flat = []  # (src, dst, seq, fidx, send_i) per live frame
            for i in idxs:
                src, dst, seq0 = (int(v) for v in routes[i])
                for f in range(n_live[i]):
                    flat.append((src, dst, (seq0 + f) % SEQ_MOD, f, i))
            ops, perm = plan.frame_ops(
                self.exchanges, [t[:4] for t in flat],
                dup_budget=len(flat),
            )
            post = []
            for op, (_, _, _, f, i) in zip(ops, flat):
                if op.kind == "drop":
                    continue
                if op.kind == "corrupt":
                    post.append((i, f, op.word, op.xor))
                    continue
                post.append((i, f, 0, 0))
                if op.kind == "dup":
                    post.append((i, f, 0, 0))
            if perm is not None:
                post = [post[p] for p in perm]
            out.append(post)
        return out

    def _dispatch_fused(
        self, sends, n_live, payloads, nbytes, routes, F_arr: int,
        fault_lists=None,
    ) -> None:
        """Fused tick (``Router.deliver_fused``): sends are grouped by
        source rank on the host (tiny tables), then framing, TX layout, the
        routed scan and the RX split all run on the device — frames never
        touch host memory between the stages.  The scan bound comes from the
        tick's actual demand (``Router.plan_steps``).

        ``fault_lists`` (``_plan_frame_faults``) maps onto this engine's
        canonical row layout — send ``j`` frame ``f`` lives at TX row
        ``j * F_arr + f`` — as a (gather, xor, valid) triple applied after
        framing."""
        R = self.n_ranks
        per_rank: List[List[int]] = [[] for _ in range(R)]
        for i, (src, _, _, _) in enumerate(sends):
            per_rank[src].append(i)
        Bmax = max(1, max(len(p) for p in per_rank))
        Bmax = 1 << (Bmax - 1).bit_length()  # pow2-bucket sends per rank
        if fault_lists is not None and self.faults.duplicate > 0:
            # duplicated frames need spare TX rows: the post-fault list can
            # reach 2x a rank's live frames, so double the row budget
            Bmax *= 2
        Wcap = payloads.shape[1]
        p_r = np.zeros((R, Bmax, Wcap), np.uint32)
        nb_r = np.zeros((R, Bmax), np.int32)
        rt_r = np.zeros((R, Bmax, 3), np.int32)
        lv_r = np.zeros((R, Bmax), np.uint32)
        sv_r = np.zeros((R, Bmax), bool)
        for r, idxs in enumerate(per_rank):
            for j, i in enumerate(idxs):
                p_r[r, j] = payloads[i]
                nb_r[r, j] = nbytes[i]
                rt_r[r, j] = routes[i]
                lv_r[r, j] = sends[i][3]
                sv_r[r, j] = True
        T = Bmax * F_arr
        if fault_lists is None:
            # the reference's 32-frame bucket of the live-frame bound (it
            # sizes the queues, q_cap scales with total)
            total = min(-(-sum(n_live) // 32) * 32, R * T)
            axis_steps = self.router.plan_steps(
                [s for s, _, _, _ in sends], [d for _, d, _, _ in sends],
                n_live,
            )
            faults = None
        else:
            # demand bounds from the POST-fault frames (what actually
            # rides the links), one count per surviving frame
            W = self.config.frame_width
            fsrcs: List[int] = []
            fdsts: List[int] = []
            gather = np.zeros((R, T), np.int32)
            xor = np.zeros((R, T, W), np.uint32)
            fvalid = np.zeros((R, T), bool)
            for r, post in enumerate(fault_lists):
                jmap = {i: j for j, i in enumerate(per_rank[r])}
                for k, (i, f, w, x) in enumerate(post[:T]):
                    gather[r, k] = jmap[i] * F_arr + f
                    if x:
                        xor[r, k, w] = x
                    fvalid[r, k] = True
                    fsrcs.append(r)
                    fdsts.append(sends[i][1])
            total = min(-(-max(len(fsrcs), 1) // 32) * 32, R * T)
            axis_steps = self.router.plan_steps(
                fsrcs, fdsts, [1] * len(fsrcs)
            )
            faults = (gather, xor, fvalid)
        out = self.router.deliver_fused(
            p_r, nb_r, rt_r, lv_r, sv_r, axis_steps=axis_steps, total=total,
            faults=faults,
        )
        self._inflight = ("fused",) + self._stage(out)

    def _dispatch_programs(
        self, sends, n_live, payloads, nbytes, routes, T: int, total: int,
        pf: int, frame_words: int, fault_lists=None,
    ) -> None:
        """The three-stage tick (framing -> host scatter -> router; the RX
        split happens at completion).  Kept for fault injection
        (``tx_hook`` needs the framed TX on the host) and as the regression
        oracle of the fused tick.  ``fault_lists`` (``_plan_frame_faults``)
        applies to the host-packed rows — the same post-fault frame list
        the fused engine gathers on the device."""
        B = len(sends)
        F_arr = pf + 1
        adaptive = self.config.adaptive
        levels = {lvl for _, _, _, lvl in sends}
        if len(levels) == 1:
            frames = self._encode(payloads, nbytes, routes, levels.pop(), adaptive)
        else:  # mixed levels: one batched pass per level, scatter back
            frames = np.zeros((B, F_arr, HDR_WORDS + frame_words), np.uint32)
            for lvl in sorted(levels):
                idx = [i for i, s in enumerate(sends) if s[3] == lvl]
                frames[idx] = self._encode(
                    payloads[idx], nbytes[idx], routes[idx], lvl, adaptive,
                )

        # scatter live frames into per-rank tx rows
        R = self.n_ranks
        rows: List[List[np.ndarray]] = [[] for _ in range(R)]
        if fault_lists is not None:
            for r, post in enumerate(fault_lists):
                for (i, f, w, x) in post:
                    fr = frames[i, f]
                    if x:
                        fr = fr.copy()
                        fr[w] ^= np.uint32(x)
                    rows[r].append(fr)
        else:
            for i, (src, _, _, _) in enumerate(sends):
                rows[src].extend(frames[i, : n_live[i]])
        tx = np.zeros((R, T, HDR_WORDS + frame_words), np.uint32)
        tx_valid = np.zeros((R, T), bool)
        for r, fr in enumerate(rows):
            if fr:
                tx[r, : len(fr)] = np.stack(fr)
                tx_valid[r, : len(fr)] = True

        if self.tx_hook is not None:
            tx = np.asarray(self.tx_hook(tx, tx_valid))
        out = self.router.deliver(tx, tx_valid, total_frames=total)
        self._inflight = ("frames", None) + out

    def _stage(self, out: Tuple[torch.Tensor, ...]) -> Tuple:
        """``(ready, *host outputs)`` of a fused tick.  On a CUDA device
        every output is copied into pinned host memory with
        ``non_blocking=True`` and ``ready`` is an event recorded after the
        copies, so :meth:`_complete` waits for this tick alone; on the CPU
        the outputs are host tensors already (``ready`` is None)."""
        if self.router.device.type != "cuda":
            return (None,) + tuple(out)
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out)
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.router.device))
        return (ready,) + host

    def poll(self) -> bool:
        """Complete the in-flight async tick, reassembling its messages into
        the inboxes.  Returns True when a tick was completed."""
        if self._inflight is None:
            return False
        self._complete()
        return True

    def _complete(self) -> None:
        """RX readback + reassembly of the in-flight tick (the host half of
        the exchange, deferred by ``exchange_async``).  This is the ONLY
        point where delivered frames are materialized as host bytes."""
        kind, ready, *out = self._inflight
        self._inflight = None
        if ready is not None:
            ready.synchronize()  # this tick's staged outputs, nothing later
        if kind == "fused":  # RX split already happened inside the tick
            rx_hdr, rx_pay, rx_cnt, ok, crc_ok, rx_step, rx_att, ctr = out
        else:
            rx, rx_cnt, ok, crc_ok, rx_step, rx_att, ctr = out
        self.last_crc_ok = bool(crc_ok.all())
        self._fold_counters(ctr.cpu().numpy(), kind)
        if not bool(ok.all()):
            raise RuntimeError(
                "fabric routing failed (undeliverable frame or buffer "
                "overflow) — check ranks and FabricConfig capacities"
            )
        counts = [int(c) for c in rx_cnt.cpu()]
        self.frames_routed += sum(counts)
        if not any(counts):
            return

        def live(t: torch.Tensor) -> torch.Tensor:
            """Every rank's delivered rows, rank after rank."""
            return torch.cat([t[r, :c] for r, c in enumerate(counts) if c])

        steps = live(rx_step).cpu().numpy()
        atts = live(rx_att).cpu().numpy()
        if kind == "fused":
            hdrs, pays = lanes_u32(live(rx_hdr)), lanes_u32(live(rx_pay))
        else:
            # RX split on the kernel: one batched call separates every
            # delivered frame into header + payload rows
            hdr, pay = decode_frames_batch(live(rx))
            hdrs, pays = lanes_u32(hdr), lanes_u32(pay)
        reassemble = (
            self._reassemble_arq if self.config.arq else self._reassemble
        )
        off = 0
        for r, c in enumerate(counts):
            if c:
                reassemble(
                    r, hdrs[off : off + c], pays[off : off + c],
                    steps[off : off + c], atts[off : off + c],
                )
                off += c

    def _encode(self, payloads, nbytes, routes, list_level, adaptive):
        """Batched SER of B sends on the device (structure pass + the
        ``pack_frames_batch`` kernel); returns the frames as u32 numpy."""
        r = self.router
        frames, _ = encode_frames_batch(
            r._tensor(payloads), r._tensor(nbytes), r._tensor(routes),
            list_level=list_level, frame_phits=self.config.frame_phits,
            adaptive=adaptive,
        )
        return lanes_u32(frames)

    # -- receive side ------------------------------------------------------

    def _reassemble(
        self, rank: int, hdrs: np.ndarray, pays: np.ndarray,
        steps: Optional[np.ndarray] = None,
        atts: Optional[np.ndarray] = None,
    ) -> None:
        """Order a rank's delivered frames per source and cut messages at
        the end-of-list terminators."""
        if steps is None:
            steps = np.zeros(len(hdrs), np.int32)
        if atts is None:
            atts = np.zeros(
                (len(hdrs), n_att(len(self.router.axis_names))), np.int32
            )
        srcs = (hdrs[:, HDR_ROUTE] >> 24) & 0x7F  # bit 31 = adaptive flag
        for src in sorted(set(int(s) for s in srcs)):
            sel = srcs == src
            mh, mp, ms, ma = hdrs[sel], pays[sel], steps[sel], atts[sel]
            base = self._rx_seq[rank][src]
            seqs = (mh[:, HDR_ROUTE] & 0xFFFF).astype(np.int64)
            order = np.argsort((seqs - base) % SEQ_MOD)
            part = self._partial[rank][src]
            expected = base
            for j in order:
                size = int(mh[j, HDR_SIZE])
                part.level = int(mh[j, HDR_LEVEL])
                if part.seq0 is None:
                    part.seq0 = int(seqs[j])
                # the message's attribution is its CRITICAL frame's — the
                # one that arrived last (ties: the later seq wins; equal
                # steps mean equal component sums)
                sj = int(ms[j])
                if part.att is None or sj >= part.step:
                    part.att = ma[j].copy()
                # scan steps restart at 0 each tick, but a message's frames
                # all ride ONE tick (exchange frames every pending send
                # together), so the max is within-tick; a partial spanning
                # ticks means lost frames and the message is flagged anyway
                part.step = max(part.step, sj)
                # CRC covers size | level | route | payload (frames.py)
                covered = np.concatenate(
                    [mh[j, [HDR_SIZE, HDR_LEVEL, HDR_ROUTE]], mp[j]]
                )
                if int(mh[j, HDR_CRC]) != zlib.crc32(covered.tobytes()):
                    part.ok = False
                if int(seqs[j]) != expected:
                    # gap in the stream (lost/misrouted frame): the message
                    # around it cannot be trusted
                    part.ok = False
                expected = (int(seqs[j]) + 1) % SEQ_MOD
                if size == 0:  # terminator: message complete
                    self._deliver(rank, src, part)
                    self._partial[rank][src] = part = _PartialMsg()
                else:
                    part.data.extend(mp[j].tobytes()[:size])
            self._rx_seq[rank][src] = expected

    # -- ARQ: reliable delivery (config.arq) -------------------------------

    def _materialize_arq_counters(self) -> None:
        """Touch every ``fabric.arq.*`` counter so zero-fault snapshots
        export the full catalog (the SLO ``max_retransmit_ratio`` must
        observe 0, never an absent signal) — re-run each tick because the
        serve plane swaps in its own registry post-construction."""
        for name in ARQ_COUNTERS:
            self.metrics.counter(f"fabric.arq.{name}").add(0)

    def _reassemble_arq(
        self, rank: int, hdrs: np.ndarray, pays: np.ndarray,
        steps: np.ndarray, atts: np.ndarray,
    ) -> None:
        """The ARQ receive path: CRC-filter, demux control records, buffer
        out-of-order survivors in the seq window, drain in-order runs into
        deliveries, and turn gaps into NACKs.

        Unlike the legacy path, a CRC failure or gap here produces NO
        flagged delivery — the damage becomes recovery traffic and the
        message arrives intact (byte-identical) on a later tick.  Only a
        gap that outlives ``skip_after`` degrades to a flagged delivery
        (``_arq_skip``)."""
        cfg = self.config
        # CRC-filter EVERYTHING first: a corrupt frame's route word is
        # untrustworthy, so grouping by src — or liveness bookkeeping —
        # keyed on it could misattribute damage to a healthy peer
        good = np.ones(len(hdrs), bool)
        for j in range(len(hdrs)):
            covered = np.concatenate(
                [hdrs[j, [HDR_SIZE, HDR_LEVEL, HDR_ROUTE]], pays[j]]
            )
            if int(hdrs[j, HDR_CRC]) != zlib.crc32(covered.tobytes()):
                good[j] = False
        dropped = int(len(hdrs) - good.sum())
        if dropped:
            self.metrics.counter("fabric.arq.crc_dropped").add(dropped)
        hdrs, pays = hdrs[good], pays[good]
        steps, atts = steps[good], atts[good]
        srcs = (hdrs[:, HDR_ROUTE] >> 24) & 0x7F
        levels = hdrs[:, HDR_LEVEL]
        seqs = (hdrs[:, HDR_ROUTE] & 0xFFFF).astype(np.int64)
        for src in sorted(set(int(s) for s in srcs)):
            sel = srcs == src
            self._last_heard[rank][src] = self.ticks
            ctl = sel & (levels == cfg.arq_level)
            # control records are single-frame and self-contained: parse
            # each payload frame standalone by magic, ignore terminators
            for j in np.nonzero(ctl)[0]:
                if int(hdrs[j, HDR_SIZE]) >= 12 \
                        and int(pays[j, 0]) == ARQ_MAGIC:
                    self._handle_ctl(rank, src, int(pays[j, 1]),
                                     int(pays[j, 2]))
            data = np.nonzero(sel & ~ctl)[0]
            if len(data) == 0:
                continue
            ooo = self._ooo[rank][src]
            expected = self._rx_seq[rank][src]
            dup = 0
            for j in data:
                seq = int(seqs[j])
                d = (seq - expected) % SEQ_MOD
                if d >= SEQ_MOD // 2 or seq in ooo:
                    # behind the window (already drained) or already
                    # buffered: a retransmit race or an injected dup
                    dup += 1
                    continue
                ooo[seq] = (int(hdrs[j, HDR_SIZE]), int(levels[j]),
                            pays[j].copy(), int(steps[j]), atts[j].copy())
            if dup:
                self.metrics.counter("fabric.arq.dup_suppressed").add(dup)
                # a duplicate means the sender never got our ACK (or a
                # fault cloned the frame): answer with an immediate
                # cumulative ACK so timeout retransmission of
                # already-delivered data stops instead of looping
                self._ack_now(rank, src)
            self._drain_inorder(rank, src)

    def _drain_inorder(self, rank: int, src: int) -> None:
        """Drain the in-order run at the front of the (rank, src) seq
        window into partials/deliveries; note gaps (NACK) and owed ACKs."""
        ooo = self._ooo[rank][src]
        expected = self._rx_seq[rank][src]
        progressed = False
        part = self._partial[rank][src]
        while expected in ooo:
            size, level, pay, step, att = ooo.pop(expected)
            part.level = level
            if part.seq0 is None:
                part.seq0 = expected
            if part.att is None or step >= part.step:
                part.att = att.copy()
            part.step = max(part.step, step)
            if size == 0:  # terminator: message complete — and clean
                self._deliver(rank, src, part)
                self._partial[rank][src] = part = _PartialMsg()
            else:
                part.data.extend(pay.tobytes()[:size])
            expected = (expected + 1) % SEQ_MOD
            progressed = True
        self._rx_seq[rank][src] = expected
        if progressed:
            self._ack_owed[rank][src] = True
        if ooo:
            # frames beyond a hole: the run above stopped at a lost or
            # still-in-flight seq — NACK it now, re-NACK on the timeout
            # cadence (_arq_tick) while it persists.  Progress moves the
            # gap FRONT, so it restarts the skip horizon too: only a
            # stream making no progress at all for skip_after ticks is
            # given up on, not one steadily recovering a long burst.
            if self._gap_since[rank][src] is None or progressed:
                self._gap_since[rank][src] = self.ticks
                self._nack_now(rank, src)
        else:
            self._gap_since[rank][src] = None

    def _ack_now(self, rank: int, src: int) -> None:
        self._send_ctl(rank, src, ARQ_ACK, self._rx_seq[rank][src])
        self._last_ack[rank][src] = self.ticks
        self._ack_owed[rank][src] = False
        self.metrics.counter("fabric.arq.acks").add(1)

    def _nack_now(self, rank: int, src: int) -> None:
        self._send_ctl(rank, src, ARQ_NACK, self._rx_seq[rank][src])
        self._last_nack[rank][src] = self.ticks
        self.metrics.counter("fabric.arq.nacks").add(1)

    def _handle_ctl(self, rank: int, src: int, kind: int, ack: int) -> None:
        """One control record arrived at ``rank`` from ``src`` — it talks
        about the data stream ``rank -> src``.  Cumulative ACK drops the
        covered prefix of the retransmit buffer; a NACK additionally
        retransmits the entry holding the seq the receiver is stuck at
        (only that entry — later ones may already sit in its window, and
        blind retransmission would burn their retry budgets)."""
        buf = self._retx.get((rank, src))
        if not buf:
            return
        while buf:  # entries registered in seq order: ACK covers a prefix
            e = buf[0]
            d = (ack - e["seq0"]) % SEQ_MOD
            if e["n"] <= d < SEQ_MOD // 2:
                buf.popleft()
            else:
                break
        if kind != ARQ_NACK or not buf:
            return
        e = buf[0]
        d = (ack - e["seq0"]) % SEQ_MOD
        if d < e["n"] and e["last_tx"] < self.ticks:
            if e["retries"] >= self.config.max_retries:
                self._abort_entry(rank, src, e, buf)
            else:
                e["retries"] += 1
                e["last_tx"] = self.ticks
                self._queue_retransmit(rank, src, e)

    def _retx_register(self, src: int, dst: int, seq0: int, n: int,
                       wire: bytes, level: int,
                       rid: Optional[int]) -> None:
        buf = self._retx.setdefault((src, dst), deque())
        buf.append({"seq0": seq0, "n": n, "wire": wire, "level": level,
                    "rid": rid, "last_tx": self.ticks, "retries": 0})
        total = sum(e["n"] for e in buf)
        # bounded buffer (config.arq_buffer FRAMES): evict oldest to the
        # dead letters — but never the entry just added, however large
        while total > self.config.arq_buffer and len(buf) > 1:
            ev = buf.popleft()
            total -= ev["n"]
            self._dead.append(dict(ev, src=src, dst=dst))
            self.metrics.counter("fabric.arq.evicted").add(1)

    def _queue_retransmit(self, src: int, dst: int, e: dict) -> None:
        """Re-queue a buffered message under its ORIGINAL (pinned) seq
        range — the receiver's window dedups if the original arrives
        after all.  Counted in FRAMES so ``max_retransmit_ratio`` divides
        like for like against ``fabric.frames.delivered``."""
        self._pending.append((src, dst, e["wire"], e["level"]))
        self._pending_meta.append({"rid": None, "seq0": e["seq0"],
                                   "ctl": False})
        self.metrics.counter("fabric.arq.retransmits").add(e["n"])

    def _abort_entry(self, src: int, dst: int, e: dict, buf: deque) -> None:
        """Give up on a message past ``max_retries``: out of the live
        buffer, into the dead letters (``drain(on_corrupt='retry')`` and
        the serve plane's re-placement can still reach the bytes)."""
        try:
            buf.remove(e)
        except ValueError:
            pass
        self._dead.append(dict(e, src=src, dst=dst))
        self.metrics.counter("fabric.arq.aborts").add(1)

    def _arq_tick(self) -> None:
        """Host-side ARQ clockwork, run once per fabric tick BEFORE
        dispatch: sender timeout retransmits (capped exponential backoff),
        receiver owed-ACK coalescing, gap re-NACKs, and skip give-ups.
        Anything queued here rides THIS tick's exchange."""
        cfg = self.config
        for (src, dst), buf in self._retx.items():
            for e in list(buf):
                wait = cfg.retransmit_timeout * min(1 << e["retries"], 32)
                if self.ticks - e["last_tx"] < wait:
                    continue
                if e["retries"] >= cfg.max_retries:
                    self._abort_entry(src, dst, e, buf)
                    continue
                e["retries"] += 1
                e["last_tx"] = self.ticks
                self.metrics.counter("fabric.arq.timeouts").add(1)
                self._queue_retransmit(src, dst, e)
        skip_after = cfg.skip_after
        R = self.n_ranks
        for rank in range(R):
            for src in range(R):
                gap = self._gap_since[rank][src]
                if gap is not None:
                    if self.ticks - gap >= skip_after:
                        self._arq_skip(rank, src)
                    elif (self.ticks - self._last_nack[rank][src]
                          >= cfg.retransmit_timeout):
                        self._nack_now(rank, src)
                elif self._ack_owed[rank][src] and (
                    self.ticks - self._last_ack[rank][src]
                    >= cfg.arq_ack_every
                ):
                    self._ack_now(rank, src)

    def _arq_skip(self, rank: int, src: int) -> None:
        """Give up on a gap that outlived the whole retransmit schedule:
        flag the partial (``ok=False``), walk the buffered
        out-of-order frames legacy-style (every residual hole keeps
        flagging), and resync ``expected`` past them — a dead peer
        degrades the stream instead of wedging it.  Sender convergence
        needs no extra protocol: the next cumulative ACK (owed below)
        covers the skipped seqs and clears its buffer."""
        ooo = self._ooo[rank][src]
        expected = self._rx_seq[rank][src]
        part = self._partial[rank][src]
        part.ok = False
        for seq in sorted(ooo, key=lambda s: (s - expected) % SEQ_MOD):
            size, level, pay, step, att = ooo.pop(seq)
            part.level = level
            if part.seq0 is None:
                part.seq0 = seq
            if part.att is None or step >= part.step:
                part.att = att.copy()
            part.step = max(part.step, step)
            if seq != expected:
                part.ok = False
            expected = (seq + 1) % SEQ_MOD
            if size == 0:
                self._deliver(rank, src, part)
                self._partial[rank][src] = part = _PartialMsg()
            else:
                part.data.extend(pay.tobytes()[:size])
        self._rx_seq[rank][src] = expected
        self._gap_since[rank][src] = None
        self._ack_owed[rank][src] = True
        self.metrics.counter("fabric.arq.skips").add(1)

    def last_heard_tick(self, rank: int, src: int) -> Optional[int]:
        """Tick anything (data or control) last arrived at ``rank`` from
        ``src`` — None until the first frame.  The serve plane's blackout
        detector compares this against its suspect horizon."""
        return self._last_heard[rank][src]

    def ticks_since_heard(self, rank: int, src: int) -> Optional[int]:
        t = self._last_heard[rank][src]
        return None if t is None else self.ticks - t

    def _deliver(self, rank: int, src: int, part: _PartialMsg) -> None:
        """Finalize one reassembled message: attach its flight-recorder
        attribution and (when the sender tagged it) its request id, emit
        the span events, and append the Delivery to the rank's inbox."""
        n_axes = len(self.router.axis_names)
        att = FrameAttribution.from_vector(
            n_axes, part.att if part.att is not None else [0] * n_att(n_axes)
        )
        rid = self._match_rid(rank, src, part.seq0)
        self._inbox[rank].append(
            Delivery(src, bytes(part.data), part.ok, part.level, part.step,
                     attribution=att, request_id=rid, seq0=part.seq0)
        )
        self._record_arrive(rank, part.level, part.step, att)

    def _match_rid(self, rank: int, src: int,
                   seq0: Optional[int]) -> Optional[int]:
        """Match a reassembled message's first-frame seq into the pending
        (src -> rank) rid ranges recorded at dispatch (wrap-aware)."""
        spans = self._send_spans.get((rank, src))
        if not spans or seq0 is None:
            return None
        for i, (s0, n, rid) in enumerate(spans):
            if (seq0 - s0) % SEQ_MOD < n:
                spans.pop(i)
                return rid
        return None

    def drain(self, rank: int, on_corrupt: str = "flag") -> List[Delivery]:
        """Drain messages delivered to ``rank``.

        ``on_corrupt`` picks the corruption posture:

        * ``"flag"`` (default) — return corrupt deliveries with
          ``ok=False`` (flag-only delivery).
        * ``"raise"`` — raise :class:`FabricCorruption` when any drained
          delivery is corrupt, with the inbox left INTACT so the caller
          can re-drain with ``"flag"`` and inspect the damage.
        * ``"retry"`` (requires ``arq=True``) — ask the SENDER to replay
          its buffered copy under a fresh seq: the corrupt delivery is
          dropped here and the clean replay arrives on a later tick.  One
          replay per message; a message the sender no longer holds
          (buffer evicted and rotated out of the dead letters) is
          returned flagged as the fallback.
        """
        if on_corrupt not in ("flag", "raise", "retry"):
            raise ValueError(
                f"on_corrupt must be 'flag', 'raise' or 'retry', got "
                f"{on_corrupt!r}"
            )
        if on_corrupt == "retry" and not self.config.arq:
            raise ValueError(
                "on_corrupt='retry' needs FabricConfig(arq=True): replays "
                "come from the sender's ARQ retransmit buffer"
            )
        if on_corrupt == "raise":
            bad = sorted({d.src for d in self._inbox[rank] if not d.ok})
            if bad:
                raise FabricCorruption(
                    f"rank {rank}: corrupt deliveries from src(s) {bad} "
                    f"(CRC failure or unrepaired seq gap) — drain with "
                    f"on_corrupt='flag' to inspect"
                )
        out, self._inbox[rank] = self._inbox[rank], []
        if on_corrupt != "retry" or all(d.ok for d in out):
            return out
        kept = []
        for d in out:
            if d.ok or not self._replay(rank, d):
                kept.append(d)
        return kept

    def _replay(self, rank: int, d: Delivery) -> bool:
        """Queue a sender-side replay of a corrupt delivery: same wire /
        level / rid, FRESH seq range (the original range was consumed by
        the flagged delivery, so pinning would dedup the replay away).
        Returns False when no buffered copy exists or this message was
        already replayed once (``_replayed`` breaks retry loops)."""
        if d.seq0 is None:
            return False
        key = (rank, d.src, d.seq0)
        if key in self._replayed:
            return False
        entry = None
        for e in self._retx.get((d.src, rank), ()):  # still buffered
            if (d.seq0 - e["seq0"]) % SEQ_MOD < e["n"]:
                entry = e
                break
        if entry is None:
            for e in self._dead:  # aborted / evicted copies
                if e.get("src") == d.src and e.get("dst") == rank \
                        and (d.seq0 - e["seq0"]) % SEQ_MOD < e["n"]:
                    entry = e
                    break
        if entry is None:
            return False
        self._replayed.add(key)
        self._pending.append((d.src, rank, entry["wire"], entry["level"]))
        self._pending_meta.append({
            "rid": entry.get("rid"), "seq0": None, "ctl": False,
        })
        self.metrics.counter("fabric.arq.replays").add(1)
        return True

    # -- telemetry folds (the host half of the obs plane) ------------------

    def _note_expected(self, sends, n_live) -> None:
        """Fold this tick's STATIC per-(link, direction) demand —
        ``analysis.comm.demand_link_loads`` of exactly the sends being
        dispatched — into the accumulated expected-load matrix."""
        from ..analysis.comm import demand_link_loads

        loads = demand_link_loads(
            self.router.sizes,
            [s for s, _, _, _ in sends],
            [d for _, d, _, _ in sends],
            n_live,
            self.config.adaptive,
        )
        for ai, group in enumerate(loads):
            acc = self._expected_loads[ai]
            for key, ll in group.items():
                acc[key] = acc.get(key, 0) + ll.frames

    def _fold_counters(self, ctr: np.ndarray, kind: str) -> None:
        """Fold one tick's per-rank on-device counter block into the
        all-time totals, the per-tick delta window, and the metrics
        registry."""
        delta = ctr.astype(np.int64)
        if self.config.arq:
            self._materialize_arq_counters()
        self._ctr_total += delta
        self._ctr_window.append(delta)
        axes = self.router.axis_names
        tot = delta.sum(axis=0)
        m = self.metrics
        m.counter("fabric.ticks", engine=kind).add(1)
        m.counter("fabric.frames.delivered").add(
            int(tot[global_index(len(axes), "delivered")])
        )
        m.counter("fabric.crc.failures").add(
            int(tot[global_index(len(axes), "crc_fail")])
        )
        for ai, axis in enumerate(axes):
            for di, dname in enumerate(DIR_SLOTS):
                for fname in CTR_FIELDS:
                    v = int(tot[ctr_index(ai, di, fname)])
                    if v:
                        m.counter(f"fabric.link.{fname}",
                                  axis=axis, dir=dname).add(v)

    def counters_total(self) -> np.ndarray:
        """All-time per-rank on-device counter block, ``(ranks,
        n_counters)`` int64 in the ``repro.obs.counters`` layout."""
        return self._ctr_total.copy()

    def observed_link_loads(self, window: Optional[int] = None):
        """The OBSERVED per-(link, direction) load matrix, folded from the
        on-device ``entered`` counters and keyed exactly like the static
        ``analysis.comm.demand_link_loads`` matrix.  ``window`` restricts
        the fold to the most recent N ticks (the live view a self-tuning
        fabric would consume); default is all-time."""
        if window is not None:
            ticks = list(self._ctr_window)[-window:]
            delta = (
                np.sum(ticks, axis=0) if ticks
                else np.zeros_like(self._ctr_total)
            )
        else:
            delta = self._ctr_total
        return _observed_link_loads(self.router.sizes, delta)

    def expected_link_loads(self):
        """Accumulated static demand matrix of every dispatched tick (the
        expected side of the drift check), per-axis ``{(ring, dir):
        frames}``."""
        return tuple(dict(g) for g in self._expected_loads)

    def load_drift(self) -> Dict[Tuple, Tuple[int, int]]:
        """Static-vs-observed load divergence: empty dict when every frame
        rode exactly the link the analyzer predicted; a dropped, misrouted
        or defected frame shows up as ``{(axis, ring, dir): (expected,
        observed)}``.  Deterministic workloads without defection must see
        ``{}`` — property-tested."""
        return _load_drift(self.expected_link_loads(),
                           self.observed_link_loads())

    # -- congestion observability -----------------------------------------

    @property
    def n_classes(self) -> int:
        """QoS credit classes the router schedules (1 = single-class FIFO)."""
        return len(self.config.qos_weights) if self.config.qos_weights else 1

    def _record_arrive(self, rank: int, level: int, step: int,
                       att: Optional[FrameAttribution] = None) -> None:
        cls = level % self.n_classes
        self._arrive[rank].record(cls, step)
        self.metrics.histogram("fabric.arrive.step", cls=cls).observe(step)
        if att is not None:
            # latency-attribution histograms (flight recorder fold): where
            # each message's in-fabric time went, by QoS class
            for name, v in att.components().items():
                self.metrics.histogram(
                    f"fabric.attr.{name}", cls=cls
                ).observe(v)

    def class_arrive_stats(self, rank: int) -> Dict[int, Dict[str, float]]:
        """Per-QoS-class arrive-step percentiles of the messages recently
        delivered to ``rank`` (sliding window of 256 per class): ``{class:
        {n, mean, p95, max, jitter}}`` — the congestion signal a
        backpressure-fed sender (``stream.plane.ChunkLane``) clamps on.
        Classes key as ``list_level % n_classes``, matching the router's
        WRR credit scheduler.  The window math is ``obs.metrics``'s shared
        implementation — byte-identical to ``StreamReader``'s, so the two
        ends of the feedback loop can never disagree on "p95"."""
        return self._arrive[rank].stats()


class Mailbox:
    """Per-rank send/recv endpoint on a :class:`Fabric`."""

    def __init__(self, fabric: Fabric, rank: int):
        self.fabric = fabric
        self.rank = rank

    def send(self, dst: int, wire: bytes, list_level: int = 1,
             request_id: Optional[int] = None) -> None:
        """Queue a whole HGum wire for delivery to ``dst`` (routed, framed).

        ``request_id`` tags the message with an obs.spans span id; the
        receiver's Delivery carries it back (see :meth:`Fabric.send`)."""
        self.fabric.send(self.rank, dst, wire, list_level,
                         request_id=request_id)

    def recv(self, on_corrupt: str = "flag") -> List[Delivery]:
        """Drain messages delivered to this rank (run ``exchange`` first).
        ``on_corrupt`` = ``"flag"`` / ``"raise"`` / ``"retry"`` — see
        :meth:`Fabric.drain`."""
        return self.fabric.drain(self.rank, on_corrupt=on_corrupt)

    def arrive_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-QoS-class arrive-step percentiles of this rank's recent
        deliveries (see :meth:`Fabric.class_arrive_stats`)."""
        return self.fabric.class_arrive_stats(self.rank)
