"""Serving entry points: the batched HGum message plane + continuous batching, on the card.

Counterpart of the batched and sharded planes of ``repro.launch.serve``.
Requests arrive as HGum-serialized wires (``request_schema`` — a List of
prompts of unknown lengths, the paper's List case):

* **Batched plane (default)** — ``serve_requests`` takes MANY request wires
  at once.  One batched structure pass on the host
  (``core.vectorized.batch_plans``) yields a ``BatchedDecodePlan``; the DES
  payload pass then runs on the card through
  ``kernels.ops.decode_batch_kernel`` — one CUDA kernel launch per leaf
  path (``unpack_run`` for the fixed-layout ``req_id``, ``unpack_gather`` for
  the ragged prompt lengths and tokens).  The prompts feed
  ``runtime.scheduler.ContinuousBatcher`` (fixed-slot KV cache, admit/evict
  per tick), and every response goes back through the HW->SW ``SerFSM`` in
  bulk (counts after elements — paper §IV-B).
* **Sharded plane** — ``serve_requests_sharded`` routes the request wires
  over the message fabric (``repro_torch.fabric``) from the ingress, rank 0,
  to serving shards (ranks 1..R-1), each of which answers its share through
  the batched plane; the response wires ride the fabric back.  The ranks
  are rows of the fabric's tensors on the one card, and so are the shards'
  batchers: they take turns on it.
* **Streaming plane** — ``serve_requests_streaming`` places and computes
  like the sharded plane, but every decode tick each shard's tokens (and,
  with ``logprobs=True``, their logprobs as a second typed stream) leave as
  one chunk burst per lane, packed by the B7 kernel
  (``kernels.ops.encode_chunks_batch``), and stream back to the ingress
  over the fabric, overlapped with the next decode step.
* **Sequential path (baseline)** — ``serve_request`` answers one wire at a
  time with the streaming-FSM DES and its own prefill/decode loop.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --n-requests 16 --n-prompts 4 --max-new 32 --pad-to 256 --slots 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu \
      --sharded --n-shards 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu \
      --streaming --n-shards 3 --logprobs
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..core import (
    DesFSM,
    SerFSM,
    batch_plans,
    build_rom,
    des_hw_to_sw,
    lanes_to_int,
    lanes_u32,
    msg_to_des_tokens,
    ser_sw_to_hw,
    strip_for_ser,
    tokens_to_msg,
)
from ..data.schemas import request_schema, response_schema
from ..device import DeviceLike, default_device
from ..kernels.ops import decode_batch_kernel, wires_to_u32
from ..models.model import init_params
from ..runtime.scheduler import ContinuousBatcher, SchedulerConfig
from .steps import make_prefill_step, make_serve_step

#: the three request leaves the plane consumes (the outer 'prompts' count
#: leaf is skipped: one gather fewer on the request hot path)
REQUEST_PATHS = ["req_id", "prompts.elem.tokens", "prompts.elem.tokens.elem"]


def encode_request(req_id: int, prompts: List[List[int]]) -> bytes:
    schema = request_schema()
    msg = {"req_id": req_id, "prompts": [{"tokens": p} for p in prompts]}
    return ser_sw_to_hw(schema, msg)


def decode_request(wire: bytes) -> Tuple[int, List[List[int]]]:
    """Host DES of ONE request (streaming FSM engine)."""
    schema = request_schema()
    rom = build_rom(schema)
    res = DesFSM(rom, "sw2hw").run(wire)
    msg = tokens_to_msg(schema, res.tokens)
    return msg["req_id"], [p["tokens"] for p in msg["prompts"]]


def decode_request_batch(
    wires: List[bytes], device: DeviceLike = None
) -> List[Tuple[int, List[List[int]]]]:
    """Batched DES of N request wires: one schema walk on the host, then one
    kernel launch per leaf on ``device`` (default: the card).

    The per-prompt lengths are read from the decoded *count fields* of the
    inner token lists (container paths decode like u32 leaves), so splitting
    the flat token column back into prompts needs no second walk.
    """
    bplan = batch_plans(request_schema(), wires, record_paths=REQUEST_PATHS)
    lanes, row_bytes = wires_to_u32(wires, default_device(device))
    vals = decode_batch_kernel(lanes, row_bytes, bplan, REQUEST_PATHS)
    # one copy back per leaf; the scheduler needs the prompts on the host
    rid_lanes = lanes_u32(vals["req_id"])  # (N, 1, 2)
    len_lanes = lanes_u32(vals["prompts.elem.tokens"])  # (N, capP, 1)
    tok_lanes = lanes_u32(vals["prompts.elem.tokens.elem"])  # (N, capT, 1)
    out = []
    for m in range(len(wires)):
        rid = int(lanes_to_int(rid_lanes[m], 8)[0])
        n_prompts = int(bplan.counts["prompts.elem.tokens"][m])
        n_toks = int(bplan.counts["prompts.elem.tokens.elem"][m])
        lens = len_lanes[m, :n_prompts, 0].astype(np.int64)
        toks = tok_lanes[m, :n_toks, 0]
        splits = np.split(toks, np.cumsum(lens)[:-1]) if n_prompts else []
        out.append((rid, [list(map(int, p)) for p in splits]))
    return out


def encode_response(req_id: int, outputs: List[List[int]]) -> bytes:
    """Hardware-side SER (HW->SW: counts after elements)."""
    return encode_response_batch([(req_id, outputs)])[0]


def encode_response_batch(
    responses: List[Tuple[int, List[List[int]]]]
) -> List[bytes]:
    """Bulk HW->SW SER: one schema ROM shared by every response wire."""
    schema = response_schema()
    rom = build_rom(schema)
    wires = []
    for req_id, outputs in responses:
        msg = {"req_id": req_id, "outputs": [{"tokens": o} for o in outputs]}
        toks = strip_for_ser(msg_to_des_tokens(schema, msg))
        wires.append(SerFSM(rom, "hw2sw").run(toks).wire)
    return wires


def decode_response(wire: bytes) -> Tuple[int, List[List[int]]]:
    schema = response_schema()
    msg = des_hw_to_sw(schema, wire)
    return msg["req_id"], [o["tokens"] for o in msg["outputs"]]


def _check_params_device(params, device: torch.device) -> None:
    have = params.embed.device
    if have.type != device.type or (device.index is not None and have != device):
        raise ValueError(f"params live on {have}, serving was asked on {device}")


# ---------------------------------------------------------------------------
# Sequential path — one wire at a time (baseline)
# ---------------------------------------------------------------------------


def serve_request(
    params, cfg, wire: bytes, max_new: int = 16, pad_to: int = 64,
    device: DeviceLike = None,
) -> bytes:
    """Answer ONE request wire (host FSM DES + its own prefill/decode loop)."""
    dev = default_device(device)
    _check_params_device(params, dev)
    req_id, prompts = decode_request(wire)
    if not prompts:  # zero-prompt request: nothing to generate
        return encode_response(req_id, [])
    B = len(prompts)
    S = min(pad_to, max(8, max(len(p) for p in prompts)))
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : min(len(p), S)] = p[:S]
    prefill_step = make_prefill_step(cfg, cache_len=S + max_new)
    serve_step = make_serve_step(cfg)
    tok, cache = prefill_step(params, {"tokens": torch.from_numpy(toks).to(dev)})
    out_tokens = [tok]
    for _ in range(max_new - 1):
        tok, cache = serve_step(params, cache, tok)
        out_tokens.append(tok)
    gen = torch.cat(out_tokens, dim=1).cpu().numpy()  # (B, max_new)
    return encode_response(req_id, [list(map(int, gen[i])) for i in range(B)])


# ---------------------------------------------------------------------------
# Batched plane — many wires in, many wires out
# ---------------------------------------------------------------------------


def serve_requests(
    params,
    cfg,
    wires: List[bytes],
    max_new: int = 16,
    pad_to: int = 64,
    slots: int = 8,
    admit_cap: Optional[int] = None,
    device: DeviceLike = None,
) -> List[bytes]:
    """Answer N request wires through the batched message plane on
    ``device`` (default: the CUDA card; ``params`` must live there).

    Batched structure pass -> one kernel launch per leaf -> continuous-
    batching generate -> bulk SER.  Responses come back in request order; a
    request with zero prompts yields an empty-outputs response wire.  Every
    prompt is padded/truncated to the static ``pad_to``.
    """
    dev = default_device(device)
    _check_params_device(params, dev)
    reqs = decode_request_batch(wires, dev)
    sched = SchedulerConfig(
        slots=slots, prompt_cap=pad_to, max_new=max_new, admit_cap=admit_cap
    )
    batcher = ContinuousBatcher(params, cfg, sched)
    for m, (_, prompts) in enumerate(reqs):
        for i, p in enumerate(prompts):
            batcher.submit((m, i), p)
    outs = batcher.run()
    responses = [
        (rid, [outs[(m, i)] for i in range(len(prompts))])
        for m, (rid, prompts) in enumerate(reqs)
    ]
    return encode_response_batch(responses)


# ---------------------------------------------------------------------------
# Sharded plane — requests routed over the message fabric to per-shard
# batchers
# ---------------------------------------------------------------------------


def place_requests(
    router,
    n_requests: int,
    shards: List[int],
    capacity: int,
    weights: Optional[List[int]] = None,
    exclude=(),
) -> List[int]:
    """Topology-aware ingress placement: each request goes to the nearest
    shard with free capacity.

    Shards are ordered by round-trip fabric distance from the ingress
    (``Router.route_hops(0, s) + route_hops(s, 0)``, under the router's
    routing mode); each request takes the nearest shard whose load is still
    under ``capacity``, spilling to the next nearest when full, and the
    least-loaded (nearest first) takes the overflow.  ``weights`` measures
    each request's load (default one unit each).  ``exclude`` removes
    shards entirely (the serve plane's suspects); excluding every shard
    raises.  Placement cannot change tokens — rows decode independently —
    only how far each request's wires travel.
    """
    live = [s for s in shards if s not in exclude]
    if not live:
        raise ValueError(
            f"no healthy shard to place on: all of {sorted(shards)} are "
            f"excluded (suspect)"
        )
    order = sorted(
        live,
        key=lambda s: (router.route_hops(0, s) + router.route_hops(s, 0), s),
    )
    w = weights if weights is not None else [1] * n_requests
    load = {s: 0 for s in order}
    placement = []
    for i in range(n_requests):
        free = [s for s in order if load[s] < capacity]
        s = free[0] if free else min(order, key=lambda t: load[t])
        placement.append(s)
        load[s] += max(1, w[i])
    return placement


def default_serve_fabric(
    n_shards: Optional[int] = None, routing: str = "shortest",
    defect_after: int = 0, analyze: bool = False, arq: bool = True,
    faults=None, device: DeviceLike = None,
):
    """The fabric ``serve_requests_sharded`` builds when none is passed:
    rank 0 ingress plus ``n_shards`` serving shards (default 7: 8 ranks,
    the reference's cap), shortest-path routed with the fused tick, on
    ``device`` (default: the card).  ``defect_after=k`` enables
    congestion-aware direction defection; ``arq=True`` (the serving
    default) turns on reliable delivery, so seeded chaos (``faults``, a
    ``fabric.faults.FaultPlan``) costs latency, not correctness.

    The reference sizes the fabric by its devices; here the ranks are a
    tensor axis on one card, so the count is ``n_shards + 1`` alone.
    Returns None when fewer than 2 ranks result (no shard to route to)."""
    from ..fabric import Fabric, FabricConfig

    if analyze:
        raise NotImplementedError(
            "analyze=True waits for the port of the analyzer passes "
            "(ROADMAP item 11)"
        )
    n_ranks = (n_shards + 1) if n_shards else 8
    if n_ranks < 2:
        return None
    fab = Fabric(
        n_ranks=n_ranks,
        config=FabricConfig(frame_phits=16, routing=routing,
                            defect_after=defect_after, arq=arq),
        device=device,
    )
    fab.faults = faults
    return fab


def serve_requests_sharded(
    params,
    cfg,
    wires: List[bytes],
    max_new: int = 16,
    pad_to: int = 64,
    slots: int = 8,
    admit_cap: Optional[int] = None,
    n_shards: Optional[int] = None,
    fabric=None,
    placement: Optional[List[int]] = None,
    routing: str = "shortest",
    defect_after: int = 0,
    analyze: bool = False,
    metrics=None,
    trace=None,
    suspect_after: Optional[int] = 24,
    deadline_ticks: Optional[int] = None,
    device: DeviceLike = None,
) -> List[bytes]:
    """Answer N request wires across fabric-connected serving shards.

    Rank 0 is the ingress: it routes each request wire over the fabric to
    a serving shard (ranks 1..R-1, nearest free shard first —
    ``place_requests``; pass ``placement`` to pin requests), every shard
    answers its share through the batched plane (``serve_requests``), and
    the response wires ride the fabric back to the ingress, which restores
    request order.  Byte-identical to ``serve_requests`` on the same wires:
    every prompt pads to the static ``pad_to`` and rows decode
    independently, so placement cannot change the greedy outputs.

    Failure awareness (with an ARQ fabric, the ``default_serve_fabric``
    default): the loop ticks until every request is answered or
    ``deadline_ticks`` ticks elapse (default 256 with ARQ, 3 without), and
    a shard the ingress has not heard from for more than ``suspect_after``
    ticks while it owes responses becomes a suspect: its outstanding
    requests are re-placed once onto healthy shards.  A request whose
    retry also dies raises.  ``suspect_after=None`` disables the detector.

    With fewer than 2 ranks (no shard to route to) this is the batched
    plane, as in the reference.  ``device`` (default: the card) must hold
    ``params`` and the fabric's tensors.  ``metrics`` shares a
    ``obs.MetricsRegistry`` with the fabric; ``analyze=True`` and
    ``trace=`` wait for ROADMAP item 11 and raise.
    """
    dev = default_device(device)
    _check_params_device(params, dev)
    if analyze or trace is not None:
        raise NotImplementedError(
            "analyze=True and trace= wait for the port of the analyzer "
            "passes and the trace export (ROADMAP item 11)"
        )
    if fabric is None:
        fabric = default_serve_fabric(n_shards, routing=routing,
                                      defect_after=defect_after, device=dev)
    if fabric is None or fabric.n_ranks < 2:
        return serve_requests(
            params, cfg, wires, max_new=max_new, pad_to=pad_to,
            slots=slots, admit_cap=admit_cap, device=dev,
        )
    if fabric.router.device != dev:
        raise ValueError(f"fabric lives on {fabric.router.device}, serving "
                         f"was asked on {dev}")
    if metrics is not None:
        fabric.metrics = metrics
    shards = list(range(1, fabric.n_ranks))
    ingress = fabric.mailbox(0)
    if placement is None:
        placement = place_requests(
            fabric.router, len(wires), shards, capacity=max(1, slots)
        )

    # ingress -> shards: queue[s] is the FIFO of request indices shard s
    # owes responses for (every (src, dst) stream delivers in order), so
    # the k-th response arriving from s answers queue[s][k]
    queue: Dict[int, List[int]] = {s: [] for s in shards}
    for i, w in enumerate(wires):
        queue[placement[i]].append(i)
        ingress.send(placement[i], w)

    arq = bool(fabric.config.arq)
    watch = arq and suspect_after is not None
    max_ticks = (deadline_ticks or 256) if arq else 3
    t0_tick = fabric.ticks if arq else 0
    answered: Dict[int, bytes] = {}
    cursor = {s: 0 for s in shards}
    suspects: set = set()
    retried: set = set()
    wait_since: Dict[int, int] = {}  # shard -> tick its current debt began
    for _ in range(max_ticks):
        fabric.exchange()
        # each shard answers newly arrived request wires through the
        # batched plane and sends the response wires back
        for s in shards:
            box = fabric.mailbox(s)
            arrived = box.recv()
            if s in suspects or not arrived:
                continue
            bad = [d.src for d in arrived if not d.ok]
            if bad:
                raise RuntimeError(
                    f"shard {s}: corrupt request frames from {bad}")
            resp = serve_requests(
                params, cfg, [d.wire for d in arrived], max_new=max_new,
                pad_to=pad_to, slots=slots, admit_cap=admit_cap, device=dev,
            )
            for rw in resp:
                box.send(0, rw)
        # ingress: responses arrive per shard in FIFO order; the FIRST
        # answer (original or retry) wins — both are identical
        for d in ingress.recv():
            if not d.ok:
                raise RuntimeError(
                    f"ingress: corrupt response frames from {d.src}")
            i = queue[d.src][cursor[d.src]]
            cursor[d.src] += 1
            answered.setdefault(i, d.wire)
        if len(answered) == len(wires):
            break
        if not watch:
            continue
        for s in shards:
            if s in suspects:
                continue
            outstanding = [i for i in queue[s][cursor[s]:]
                           if i not in answered]
            if not outstanding:
                wait_since.pop(s, None)
                continue  # a shard that owes nothing goes quiet, fine
            # the horizon starts when the shard last spoke OR when its
            # current debt began, whichever is later
            since = wait_since.setdefault(s, fabric.ticks)
            heard = fabric.ticks_since_heard(0, s)
            waited = (fabric.ticks - t0_tick) if heard is None else heard
            waited = min(waited, fabric.ticks - since)
            if waited <= suspect_after:
                continue
            # rank s went silent with responses outstanding: suspect it and
            # retry its in-flight requests elsewhere, once
            suspects.add(s)
            fabric.metrics.counter("serve.suspects").add(1)
            twice = [i for i in outstanding if i in retried]
            if twice:
                raise RuntimeError(
                    f"sharded serve: request(s) {twice} failed on shard "
                    f"{s} after a retry — no healthy shard answered")
            repl = place_requests(
                fabric.router, len(outstanding), shards,
                capacity=max(1, slots), exclude=suspects)
            for i, s2 in zip(outstanding, repl):
                retried.add(i)
                queue[s2].append(i)
                ingress.send(s2, wires[i])
                fabric.metrics.counter("serve.retries").add(1)
    if len(answered) < len(wires):
        missing = sorted(i for i in range(len(wires)) if i not in answered)
        raise RuntimeError(
            f"sharded serve: {len(missing)} request(s) unanswered after "
            f"{max_ticks} fabric ticks (missing {missing[:8]})")
    out = [answered[i] for i in range(len(wires))]
    if metrics is not None:
        metrics.gauge("fabric.load_drift.entries").set(
            len(fabric.load_drift())
        )
    return out


# ---------------------------------------------------------------------------
# Streaming plane — tokens leave each shard the tick they decode; composes
# the batched compute plane with repro_torch.stream over repro_torch.fabric
# ---------------------------------------------------------------------------

#: ListLevel reserved for the typed logprob side-stream when
#: ``serve_requests_streaming(logprobs=True)`` — the ingress partitions
#: deliveries between the token reader and the logprob reader by this tag,
#: so tenant QoS levels must stay below it (254 itself stays clear of the
#: fabric's ``FabricConfig.arq_level`` control class, 255)
LOGPROB_STREAM_LEVEL = 254


def serve_requests_streaming(
    params,
    cfg,
    wires: List[bytes],
    max_new: int = 16,
    pad_to: int = 64,
    slots: int = 8,
    admit_cap: Optional[int] = None,
    n_shards: Optional[int] = None,
    fabric=None,
    placement: Optional[List[int]] = None,
    qos_levels: Optional[List[int]] = None,
    overlap: bool = True,
    on_token=None,
    on_event=None,
    routing: str = "shortest",
    defect_after: int = 0,
    backpressure_p95: Optional[float] = None,
    backpressure_chunks: int = 1,
    backpressure_hold: int = 3,
    analyze: bool = False,
    metrics=None,
    trace=None,
    spans=None,
    suspect_after: Optional[int] = 24,
    deadline_ticks: Optional[int] = None,
    logprobs: bool = False,
    on_logprob=None,
    device: DeviceLike = None,
) -> List[bytes]:
    """Answer N request wires with token-level streamed responses.

    Same placement and compute as ``serve_requests_sharded`` — rank-0
    ingress, nearest-free-shard placement (weighted by each request's
    sequence count against ``slots``), one ContinuousBatcher per shard —
    but the response path streams: every decode tick, each shard writes
    the step's tokens into per-sequence ``StreamWriter``s and one
    ``ChunkLane`` burst per (shard, tenant) rides the fabric back (one B7
    kernel launch per burst).  ``on_token(req_idx, prompt_idx, step,
    token)`` fires as tokens reach the ingress; ``on_event(StreamEvent)``
    per arriving chunk.

    ``overlap=True`` (default) runs the fabric and compute double-buffered:
    each tick enqueues the batched decodes (``step_begin``), reaps the
    previous tick's chunks while they run (``Fabric.poll``, which waits on
    the previous tick's staged outputs only), syncs the decodes
    (``step_finish``), and dispatches the new bursts
    (``Fabric.exchange_async``).  ``overlap=False`` runs the same ticks
    synchronously; tokens are identical either way.

    ``qos_levels`` tags each request's chunks with a ListLevel (default 1).
    ``backpressure_p95`` feeds the ingress reader's per-class p95 arrive
    step back into every lane: a lane above the threshold trickles
    ``backpressure_chunks`` chunks per tick (0: holds, at most
    ``backpressure_hold`` flushes in a row).  Held chunks ride later bursts
    in order, so tokens and wires do not change.

    Failure awareness (with an ARQ fabric, the default): a shard the
    ingress has not heard from for more than ``suspect_after`` ticks while
    it owes live streams becomes a suspect; its batcher and lanes are
    dropped and every request that had not fully streamed there is re-sent
    once to a healthy shard, where it re-decodes under fresh stream ids.
    A request whose retry also dies raises.  When no compute remains the
    loop keeps draining for up to ``deadline_ticks`` ticks (default 256
    with ARQ, 3 without).

    ``logprobs=True`` attaches the second typed stream: per-token logprobs
    as the schema-declared ``Stream<Struct{tok, logprob}>`` on the reserved
    :data:`LOGPROB_STREAM_LEVEL`; ``on_logprob(req_idx, prompt_idx, step,
    token, logprob)`` fires per element.  The greedy pick is unchanged.

    Returns the final response wires, byte-identical to ``serve_requests``
    on the same inputs; with fewer than 2 ranks this is the batched plane.
    ``device`` (default: the card) must hold ``params`` and the fabric's
    tensors.  ``metrics`` shares an ``obs.MetricsRegistry`` with the
    fabric, the batchers, the lanes and the readers; ``analyze=True``,
    ``trace=`` and ``spans=`` wait for ROADMAP item 11 and raise.
    """
    from ..stream import ChunkLane, StreamReader, logprob_stream_plan

    dev = default_device(device)
    _check_params_device(params, dev)
    if analyze or trace is not None or spans is not None:
        raise NotImplementedError(
            "analyze=True, trace= and spans= wait for the port of the "
            "analyzer passes and the trace and span export (ROADMAP item 11)"
        )
    if fabric is None:
        fabric = default_serve_fabric(n_shards, routing=routing,
                                      defect_after=defect_after, device=dev)
    if fabric is None or fabric.n_ranks < 2:
        return serve_requests(
            params, cfg, wires, max_new=max_new, pad_to=pad_to,
            slots=slots, admit_cap=admit_cap, device=dev,
        )
    if fabric.router.device != dev:
        raise ValueError(f"fabric lives on {fabric.router.device}, serving "
                         f"was asked on {dev}")
    if metrics is not None:
        fabric.metrics = metrics  # one registry across the whole stack
    shards = list(range(1, fabric.n_ranks))
    ingress = fabric.mailbox(0)
    reqs = decode_request_batch(wires, dev)  # ingress keeps rids + prompt counts
    if placement is None:
        # the ingress decoded the burst, so placement weighs each request
        # by its sequence count: "free" = free KV slots
        placement = place_requests(
            fabric.router, len(wires), shards, capacity=max(1, slots),
            weights=[len(p) for _, p in reqs],
        )
    levels = list(qos_levels) if qos_levels is not None else [1] * len(wires)
    if logprobs and any(lvl >= LOGPROB_STREAM_LEVEL for lvl in levels):
        raise ValueError(
            f"qos_levels must stay below the reserved logprob stream "
            f"level {LOGPROB_STREAM_LEVEL} when logprobs=True"
        )

    for i, w in enumerate(wires):
        ingress.send(placement[i], w, list_level=levels[i])
    fabric.exchange()

    # shard setup: per-shard batcher + per-sequence stream writers.  The
    # k-th delivery at shard s is the k-th entry of globals_of[s]
    # (per-source FIFO; ARQ keeps it true under faults), which maps
    # shard-local stream ids back to global requests — retried requests
    # are appended to globals_of at re-send time, preserving the map.
    arq = bool(fabric.config.arq)
    watch = arq and suspect_after is not None
    t0_tick = fabric.ticks if arq else 0
    globals_of = {s: [i for i, p in enumerate(placement) if p == s]
                  for s in shards}
    sched = SchedulerConfig(
        slots=slots, prompt_cap=pad_to, max_new=max_new, admit_cap=admit_cap
    )
    batchers: Dict[int, ContinuousBatcher] = {}
    lanes: Dict[Tuple[int, int], ChunkLane] = {}
    writers: Dict[Tuple[int, int, int], object] = {}
    expected = []  # (src shard, stream_id) keys the reader must close
    # corrupt deliveries on an ARQ fabric mean the link already gave up
    # retransmitting (skip) — drop them and let the suspect machinery
    # re-place the request instead of poisoning the stream
    on_corrupt = "retry" if arq else "flag"
    reader = StreamReader(metrics=metrics, on_corrupt=on_corrupt)
    # the logprob plan gets its own reader; the reserved ListLevel
    # partitions deliveries between the two
    lp_reader = (
        StreamReader(metrics=metrics, plan=logprob_stream_plan(),
                     on_corrupt=on_corrupt)
        if logprobs else None
    )
    lp_writers: Dict[Tuple[int, int, int], object] = {}
    admitted = {s: 0 for s in shards}  # request wires admitted at s
    suspects: set = set()
    retried: set = set()
    abandoned: set = set()  # (src, stream_id) keys of dead streams

    def _admit(s: int) -> None:
        # admit newly arrived request wires at shard s into its (possibly
        # new) batcher — at setup and once per tick, so a retried request
        # re-routed to s mid-serve joins its continuous batch
        box = fabric.mailbox(s)
        arrived = box.recv()
        if not arrived:
            return
        bad = [d.src for d in arrived if not d.ok]
        if bad:
            raise RuntimeError(f"shard {s}: corrupt request frames from {bad}")
        local_reqs = decode_request_batch([d.wire for d in arrived], dev)
        batcher = batchers.get(s)
        if batcher is None:
            batcher = ContinuousBatcher(params, cfg, sched, metrics=metrics,
                                        logprobs=logprobs)
            batchers[s] = batcher
        for d, (_, prompts) in zip(arrived, local_reqs):
            k = admitted[s]
            admitted[s] += 1
            lvl = levels[globals_of[s][k]]
            lane = lanes.setdefault(
                (s, lvl),
                ChunkLane(box, 0, list_level=lvl,
                          p95_threshold=backpressure_p95,
                          clamp_chunks=backpressure_chunks,
                          max_hold=backpressure_hold,
                          metrics=metrics),
            )
            if logprobs:
                lp_lane = lanes.setdefault(
                    (s, LOGPROB_STREAM_LEVEL),
                    ChunkLane(box, 0, list_level=LOGPROB_STREAM_LEVEL,
                              plan=logprob_stream_plan(), metrics=metrics),
                )
            for j, p in enumerate(prompts):
                batcher.submit((k, j), p)
                sid = (k << 16) | j
                writers[(s, k, j)] = lane.writer(sid)
                if logprobs:
                    lp_writers[(s, k, j)] = lp_lane.writer(sid)
                expected.append((s, sid))

    for s in shards:
        _admit(s)

    def _live_expected():
        return [key for key in expected if key not in abandoned]

    def _stream_done(key) -> bool:
        st = reader.streams.get(key)
        return st is not None and st.eos

    def _mark_suspect(s: int) -> None:
        # rank s stopped ACKing: drop its compute and lanes, abandon its
        # unfinished streams, and re-send every request that had not fully
        # streamed there to a healthy shard — once.  Requests that already
        # reached EOS on s keep their streams untouched.
        suspects.add(s)
        batchers.pop(s, None)
        for table in (lanes, writers, lp_writers):
            for key in [k for k in table if k[0] == s]:
                del table[key]
        fabric.metrics.counter("serve.suspects").add(1)
        inflight = []
        for k, i in enumerate(globals_of[s]):
            keys = [(s, (k << 16) | j) for j in range(len(reqs[i][1]))]
            if k < admitted[s] and all(_stream_done(key) for key in keys):
                continue
            abandoned.update(keys)
            if i in retried:
                raise RuntimeError(
                    f"streaming serve: request {i} failed on shard {s} "
                    f"after a retry — no healthy shard answered it")
            inflight.append(i)
        if not inflight:
            return
        repl = place_requests(
            fabric.router, len(inflight), shards, capacity=max(1, slots),
            weights=[len(reqs[i][1]) for i in inflight], exclude=suspects)
        for i, s2 in zip(inflight, repl):
            retried.add(i)
            globals_of[s2].append(i)
            ingress.send(s2, wires[i], list_level=levels[i])
            fabric.metrics.counter("serve.retries").add(1)

    wait_since: Dict[int, int] = {}  # shard -> tick its current debt began

    def _check_suspects() -> None:
        for s in shards:
            if s in suspects:
                continue
            # only a shard that still owes something can be suspect
            waiting = (
                admitted[s] < len(globals_of[s])
                or any(key[0] == s and key not in abandoned
                       and not _stream_done(key) for key in expected))
            if not waiting:
                wait_since.pop(s, None)
                continue
            # the horizon starts when the shard last spoke OR when its
            # current debt began, whichever is later
            since = wait_since.setdefault(s, fabric.ticks)
            heard = fabric.ticks_since_heard(0, s)
            waited = (fabric.ticks - t0_tick) if heard is None else heard
            waited = min(waited, fabric.ticks - since)
            if waited > suspect_after:
                _mark_suspect(s)

    # the streamed tick pipeline
    t_serve0 = time.perf_counter()
    seen_first: set = set()  # stream keys that produced their first token
    tok_count = [0, 0]  # [total tokens arrived, tokens this tick]

    def _pump() -> None:
        got = ingress.recv()
        if lp_reader is not None:
            lp_got = [d for d in got if d.list_level == LOGPROB_STREAM_LEVEL]
            got = [d for d in got if d.list_level != LOGPROB_STREAM_LEVEL]
            for ev in lp_reader.feed(lp_got):
                key = (ev.src, ev.stream_id)
                if key in abandoned:
                    continue  # stale side-stream of a retried request
                if not ev.ok:
                    raise RuntimeError(
                        f"ingress: corrupt logprob stream chunks from "
                        f"shard {ev.src}"
                    )
                if on_logprob is not None:
                    k, j = ev.stream_id >> 16, ev.stream_id & 0xFFFF
                    m = globals_of[ev.src][k]
                    for t, (tok, bits) in enumerate(ev.tokens):
                        lpv = float(np.uint32(bits).view(np.float32))
                        on_logprob(m, j, ev.step + t, int(tok), lpv)
        for ev in reader.feed(got):
            key = (ev.src, ev.stream_id)
            if key in abandoned:
                continue  # stale chunks from a suspect shard's old stream
            if not ev.ok:
                raise RuntimeError(
                    f"ingress: corrupt stream chunks from shard {ev.src}"
                )
            tok_count[0] += len(ev.tokens)
            tok_count[1] += len(ev.tokens)
            if ev.tokens and key not in seen_first:
                seen_first.add(key)
                if metrics is not None:
                    ttft = time.perf_counter() - t_serve0
                    metrics.histogram("serve.ttft_s", base=0.001).observe(ttft)
                    metrics.series("serve.ttft_s.series").append(ttft)
            if on_event is not None:
                on_event(ev)
            if on_token is not None:
                k, j = ev.stream_id >> 16, ev.stream_id & 0xFFFF
                m = globals_of[ev.src][k]
                for t, tok in enumerate(ev.tokens):
                    on_token(m, j, ev.step + t, tok)
        per_class = (
            reader.class_arrive_stats(window=64)
            if (backpressure_p95 is not None or metrics is not None)
            else {}
        )
        if metrics is not None:
            for cls, st in per_class.items():
                metrics.series("serve.backpressure.p95",
                               cls=cls).append(st["p95"])
        if backpressure_p95 is not None:
            # close the loop: the reader's per-class p95 arrive latency
            # clamps (or releases) each lane's flush rate for next tick
            for lane in lanes.values():
                st = per_class.get(lane.list_level)
                lane.feedback(st["p95"] if st else None)

    idle = 0
    drain_cap = (deadline_ticks or 256) if arq else 3
    force_flushed = False
    while True:
        active = any(b.pending or b.n_active for b in batchers.values())
        awaiting = any(admitted[s] < len(globals_of[s])
                       for s in shards if s not in suspects)
        if (not active and not awaiting
                and reader.all_eos(_live_expected())
                and (lp_reader is None
                     or lp_reader.all_eos(_live_expected()))):
            break
        if active:
            idle = 0
            force_flushed = False
            tok_count[1] = 0
            for b in batchers.values():
                b.step_begin()  # enqueue compute; the card runs it meanwhile
            if overlap:
                fabric.poll()  # reap last tick's chunks while decode runs
                _pump()
            for s, b in list(batchers.items()):
                for (k, j), pos, tok in b.step_finish():
                    eos = pos == max_new - 1
                    writers[(s, k, j)].write((tok,), eos=eos)
                    if logprobs:
                        # the logprob element is (tok, float32 bit
                        # pattern) — the schema's Struct{tok, logprob}
                        bits = int(np.float32(
                            b.tick_logprobs[((k, j), pos)]
                        ).view(np.uint32))
                        lp_writers[(s, k, j)].write(((tok, bits),), eos=eos)
            for lane in lanes.values():
                lane.flush()  # ONE burst per (shard, tenant) this tick
            if overlap:
                fabric.exchange_async()  # dispatch routing; overlap next tick
            else:
                fabric.exchange()
                _pump()
            if metrics is not None:
                metrics.series("serve.tick.tokens").append(tok_count[1])
        else:
            # nothing left to compute: force out any bursts a clamped lane
            # still holds, then keep the fabric ticking so in-flight
            # chunks, ARQ recovery traffic and retried request wires land
            if not force_flushed:
                for lane in lanes.values():
                    lane.flush(force=True)
                force_flushed = True
            idle += 1
            if idle > drain_cap:
                raise RuntimeError(
                    "streaming serve: streams did not reach EOS")
            fabric.exchange()
            _pump()
        if watch:
            _check_suspects()
            for s in shards:
                if s not in suspects:
                    _admit(s)
    if metrics is not None:
        dt = max(time.perf_counter() - t_serve0, 1e-9)
        metrics.gauge("serve.tokens_per_s").set(tok_count[0] / dt)
        metrics.counter("serve.tokens").add(tok_count[0])
        metrics.gauge("fabric.load_drift.entries").set(
            len(fabric.load_drift())
        )

    # final wires from the streamed tokens — same bulk SER as the batched
    # plane, so the result is byte-identical to serve_requests
    outs: Dict[Tuple[int, int], List[int]] = {}
    for (src, sid), st in reader.streams.items():
        if (src, sid) in abandoned:
            continue  # a retried request's dead first attempt
        m = globals_of[src][sid >> 16]
        outs[(m, sid & 0xFFFF)] = st.tokens
    responses = [
        (rid, [outs[(m, j)] for j in range(len(prompts))])
        for m, (rid, prompts) in enumerate(reqs)
    ]
    return encode_response_batch(responses)


def synthetic_wires(cfg, n_requests: int, n_prompts: int, seed: int = 0,
                    min_len: int = 4, max_len: int = 24) -> List[bytes]:
    """Request wires with prompts of ``[min_len, max_len)`` random tokens."""
    rng = np.random.default_rng(seed)
    return [
        encode_request(r, [
            list(map(int, rng.integers(2, cfg.vocab, rng.integers(min_len, max_len))))
            for _ in range(n_prompts)
        ])
        for r in range(n_requests)
    ]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the config to its smoke size (CPU-runnable)")
    ap.add_argument("--n-requests", type=int, default=4)
    ap.add_argument("--n-prompts", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--pad-to", type=int, default=64)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--sequential", action="store_true",
                    help="use the one-wire-at-a-time path")
    ap.add_argument("--sharded", action="store_true",
                    help="route requests over the message fabric to "
                         "per-shard batchers (ranks 1..N serve, rank 0 ingress)")
    ap.add_argument("--streaming", action="store_true",
                    help="sharded serve with token-level streamed responses "
                         "(chunks ride the fabric back every decode tick)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable the async fabric/compute overlap pipeline "
                         "for --streaming")
    ap.add_argument("--logprobs", action="store_true",
                    help="for --streaming: attach the typed logprob "
                         "side-stream (Stream<Struct{tok, logprob}> from "
                         "schema JSON); tokens are byte-identical either "
                         "way")
    ap.add_argument("--n-shards", type=int, default=None,
                    help="serving shards for --sharded/--streaming (default 7)")
    ap.add_argument("--routing", choices=("shortest", "dimension"),
                    default="shortest",
                    help="fabric routing mode for --sharded/--streaming: "
                         "per-frame shortest ring direction (default) or the "
                         "+1-only dimension order")
    ap.add_argument("--defect-after", type=int, default=0,
                    help="congestion-aware routing: let a frame defect to "
                         "the opposite ring direction after its preferred "
                         "link has been credit-starved for this many "
                         "consecutive router steps (0 = static shortest)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="seeded deterministic fault injection on the serve "
                         "fabric: 'drop=0.02,corrupt=0.01,...' (see "
                         "repro_torch.fabric.faults.parse_chaos); "
                         "deterministic in --seed")
    ap.add_argument("--no-arq", action="store_true",
                    help="disable ARQ reliable delivery on the serve fabric "
                         "(corruption is flagged, never recovered)")
    ap.add_argument("--suspect-after", type=int, default=24,
                    help="mark a shard suspect — and retry its in-flight "
                         "requests on a healthy shard — after this many "
                         "fabric ticks without hearing from it (needs ARQ; "
                         "0 disables)")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="max fabric ticks to wait on in-flight deliveries "
                         "before the serve gives up (default 256 with ARQ, "
                         "3 without)")
    ap.add_argument("--backpressure-p95", type=float, default=None,
                    help="for --streaming: clamp a tenant lane's flush "
                         "rate while its QoS class's p95 arrive latency "
                         "(router steps) exceeds this threshold")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    dev = default_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    wires = synthetic_wires(cfg, args.n_requests, args.n_prompts, args.seed)
    print(f"[serve] {len(wires)} request wires, {sum(len(w) for w in wires)} bytes "
          f"total, device {dev}")
    fabric = None
    if args.sharded or args.streaming:
        from ..fabric import parse_chaos

        faults = parse_chaos(args.chaos, args.seed) if args.chaos else None
        fabric = default_serve_fabric(
            args.n_shards, routing=args.routing, defect_after=args.defect_after,
            arq=not args.no_arq, faults=faults, device=dev)
        if args.chaos and fabric is None:
            raise SystemExit("--chaos needs a multi-rank fabric (--n-shards >= 1)")
    suspect_after = args.suspect_after if args.suspect_after > 0 else None
    first_tok_t: List[float] = []
    lp_events: List[Tuple[int, float]] = []
    t0 = time.perf_counter()
    if args.sequential:
        resp_wires = [serve_request(params, cfg, w, max_new=args.max_new,
                                    pad_to=args.pad_to, device=dev) for w in wires]
    elif args.streaming:
        resp_wires = serve_requests_streaming(
            params, cfg, wires, max_new=args.max_new, pad_to=args.pad_to,
            slots=args.slots, fabric=fabric, overlap=not args.no_overlap,
            backpressure_p95=args.backpressure_p95,
            suspect_after=suspect_after, deadline_ticks=args.deadline_ticks,
            logprobs=args.logprobs,
            on_logprob=((lambda m, j, step, tok, lp: lp_events.append((tok, lp)))
                        if args.logprobs else None),
            on_token=lambda m, j, step, tok: first_tok_t.append(time.perf_counter())
            if not first_tok_t else None,
            device=dev)
    elif args.sharded:
        resp_wires = serve_requests_sharded(
            params, cfg, wires, max_new=args.max_new, pad_to=args.pad_to,
            slots=args.slots, fabric=fabric, suspect_after=suspect_after,
            deadline_ticks=args.deadline_ticks, device=dev)
    else:
        resp_wires = serve_requests(params, cfg, wires, max_new=args.max_new,
                                    pad_to=args.pad_to, slots=args.slots, device=dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for rw in resp_wires for o in decode_response(rw)[1])
    mode = ("sequential" if args.sequential
            else f"streaming(slots={args.slots})" if args.streaming
            else f"sharded(slots={args.slots})" if args.sharded
            else f"batched(slots={args.slots})")
    print(f"[serve] {mode}: {len(wires)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({len(wires)/dt:.2f} req/s, {n_tok/dt:.1f} tok/s)")
    if first_tok_t:
        print(f"[serve] time-to-first-token {first_tok_t[0] - t0:.3f}s "
              f"(vs {dt:.2f}s total)")
    if lp_events:
        tok, lp = lp_events[0]
        print(f"[serve] logprob side-stream: {len(lp_events)} events "
              f"(first tok={tok}, lp={lp:.4f})")
    if fabric is not None:
        print(f"[serve] fabric: {fabric.n_ranks} ranks, {fabric.ticks} ticks, "
              f"{fabric.router.scan_steps} router scan steps, "
              f"{fabric.frames_routed} frames routed")
    rid, outs = decode_response(resp_wires[0])
    for i, o in enumerate(outs[:2]):
        print(f"  req {rid} out[{i}][:8] = {o[:8]}")


if __name__ == "__main__":
    main()
