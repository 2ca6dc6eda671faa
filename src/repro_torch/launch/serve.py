"""Serving entry points: the batched HGum message plane + continuous batching, on the card.

Counterpart of the batched plane of ``repro.launch.serve``.  Requests
arrive as HGum-serialized wires (``request_schema`` — a List of prompts of
unknown lengths, the paper's List case):

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
* **Sequential path (baseline)** — ``serve_request`` answers one wire at a
  time with the streaming-FSM DES and its own prefill/decode loop.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.  The sharded and streaming
planes of the reference are not ported yet.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --n-requests 16 --n-prompts 4 --max-new 32 --pad-to 256 --slots 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

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
    t0 = time.perf_counter()
    if args.sequential:
        resp_wires = [serve_request(params, cfg, w, max_new=args.max_new,
                                    pad_to=args.pad_to, device=dev) for w in wires]
    else:
        resp_wires = serve_requests(params, cfg, wires, max_new=args.max_new,
                                    pad_to=args.pad_to, slots=args.slots, device=dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for rw in resp_wires for o in decode_response(rw)[1])
    mode = "sequential" if args.sequential else f"batched(slots={args.slots})"
    print(f"[serve] {mode}: {len(wires)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({len(wires)/dt:.2f} req/s, {n_tok/dt:.1f} tok/s)")
    rid, outs = decode_response(resp_wires[0])
    for i, o in enumerate(outs[:2]):
        print(f"  req {rid} out[{i}][:8] = {o[:8]}")


if __name__ == "__main__":
    main()
