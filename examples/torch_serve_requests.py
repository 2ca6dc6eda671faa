"""Batched serving over HGum wires on the PyTorch/CUDA port.

The twin of ``examples/serve_requests.py`` on ``repro_torch``, with the
same burst, flags and figures.  A burst of requests arrives as SW->HW HGum
wires (List of prompts, unknown lengths).  The batched message plane
deserializes all of them with one schema walk and one DES kernel launch
per leaf path (``kernels.ops.decode_batch_kernel``: B1 for uniform runs, B3
for ragged prompts), feeds the prompts through the continuous-batching
scheduler (fixed KV slots, admit/evict per step), and answers with HW->SW
wires serialized in bulk.

The one-wire-at-a-time path is run on the same burst for comparison.
Prompt lengths are kept >= PAD_TO so both paths pad to the same length and
must produce token-identical responses (asserted below).

With ``--sharded`` the same burst also goes through the routed message
fabric (``repro_torch.fabric``): rank 0 (ingress) routes each request wire
to a serving shard, every shard answers through its own
continuous-batching plane, and the response wires ride the multi-hop
return path back (frames built by B5 ``frame_batch``, split by B6) —
asserted byte-identical to the batched plane.

With ``--streaming`` the shards stream instead: every decode tick each
shard mails the step's tokens back as framed chunk bursts (B7
``chunk_bursts``), the fabric tick overlaps the next decode step, and the
ingress surfaces tokens the tick they arrive; the example prints the
time-to-first-token, and the final wires are asserted byte-identical to
the batched plane.

On one card the ranks are a tensor axis, so no XLA_FLAGS are needed.
Without ``--n-shards`` the fabric has 8 ranks (7 shards): the shard count
the reference gets under the README's 8 simulated devices
(``repro_torch.launch.serve.default_serve_fabric``).

Run:  PYTHONPATH=src python examples/torch_serve_requests.py \
          [--sharded|--streaming] [--device cpu]

It runs on the CUDA card unless given ``--device cpu``; without a card and
without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import DeviceLike, default_device
from repro_torch.launch.serve import (
    decode_response, default_serve_fabric, encode_request, serve_request,
    serve_requests, serve_requests_sharded, serve_requests_streaming,
)
from repro_torch.models import init_params

MAX_NEW = 8
PAD_TO = 16
N_LAYERS = 4
KW = dict(max_new=MAX_NEW, pad_to=PAD_TO, slots=8)


def model(device: DeviceLike):
    """yi-6b's float32 smoke config at 4 layers, seeded parameters."""
    dev = default_device(device)
    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")), n_layers=N_LAYERS)
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def burst(cfg) -> List[bytes]:
    """4 request wires of 1-4 prompts of PAD_TO..PAD_TO+7 tokens (seed 0)."""
    rng = np.random.default_rng(0)
    wires = []
    for req_id in range(4):
        n_prompts = int(rng.integers(1, 5))
        prompts = [
            list(map(int, rng.integers(2, cfg.vocab, rng.integers(PAD_TO, PAD_TO + 8))))
            for _ in range(n_prompts)
        ]
        wires.append(encode_request(req_id, prompts))
    return wires


def timed(fn, device: torch.device):
    """(fn(), wall seconds), a card synchronised at both ends."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    out = fn()
    sync()
    return out, time.time() - t0


def batched(params, cfg, wires, device) -> List[bytes]:
    return serve_requests(params, cfg, wires, device=device, **KW)


def sharded(params, cfg, wires, n_shards, device, metrics=None, trace=None):
    """The burst over the fabric; returns (response wires, fabric)."""
    fabric = default_serve_fabric(n_shards, device=device)
    out = serve_requests_sharded(params, cfg, wires, fabric=fabric, metrics=metrics,
                                 trace=trace, device=device, **KW)
    return out, fabric


def streaming(params, cfg, wires, n_shards, device, metrics=None, trace=None, t0=None):
    """The burst streamed per decode tick with overlap; returns (response
    wires, fabric, token arrival times in seconds after ``t0``)."""
    fabric = default_serve_fabric(n_shards, device=device)
    arrivals = []
    t0 = time.time() if t0 is None else t0
    out = serve_requests_streaming(
        params, cfg, wires, fabric=fabric, overlap=True, metrics=metrics, trace=trace,
        on_token=lambda m, j, step, tok: arrivals.append(time.time() - t0),
        device=device, **KW)
    return out, fabric, arrivals


def congestion_controlled(params, cfg, wires, n_shards, device) -> List[bytes]:
    """Defection and the backpressure-fed lane clamp: they delay bursts but
    never change tokens."""
    return serve_requests_streaming(params, cfg, wires, n_shards=n_shards, defect_after=2,
                                    backpressure_p95=4.0, device=device, **KW)


def sequential(params, cfg, wires, device) -> List[bytes]:
    return [serve_request(params, cfg, w, max_new=MAX_NEW, pad_to=PAD_TO, device=device)
            for w in wires]


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded", action="store_true",
                    help="also route the burst through the message fabric "
                         "to per-shard batchers and assert token-identity")
    ap.add_argument("--streaming", action="store_true",
                    help="also stream token chunks back from the shards "
                         "every decode tick and report time-to-first-token")
    ap.add_argument("--n-shards", type=int, default=None)
    ap.add_argument("--metrics-json", metavar="PATH",
                    help="with --sharded/--streaming: write the serve "
                         "metrics snapshot (TTFT, tokens/s, fabric "
                         "counters) as JSON; inspect with "
                         "`python -m repro_torch.obs PATH`")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="with --sharded/--streaming: write a Chrome-trace "
                         "JSON of the fabric/serve timeline (ticks, chunk "
                         "arrivals, request flow arcs) for "
                         "chrome://tracing / Perfetto")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    metrics = trace = None
    if args.metrics_json or args.trace_out:
        from repro_torch.obs import MetricsRegistry, TraceRecorder

        if args.metrics_json:
            metrics = MetricsRegistry()
        if args.trace_out:
            trace = TraceRecorder()
    cfg, params = model(dev)
    wires = burst(cfg)
    total_b = sum(len(w) for w in wires)

    # --- batched message plane ---------------------------------------
    resp_wires, dt_batched = timed(lambda: batched(params, cfg, wires, dev), dev)
    n_tok = 0
    for w, rw in zip(wires, resp_wires):
        rid, outs = decode_response(rw)
        n_tok += sum(len(o) for o in outs)
        print(f"req {rid}: {len(outs)} prompts ({len(w)} B) -> "
              f"{sum(len(o) for o in outs)} tokens ({len(rw)} B)")
        for i, o in enumerate(outs[:2]):
            print(f"   out[{i}] = {o}")
    print(f"[batched]    {len(wires)} requests ({total_b} B) -> {n_tok} tokens "
          f"in {dt_batched:.2f}s ({n_tok / dt_batched:.1f} tok/s) on {dev}")

    # --- sharded plane over the message fabric -----------------------
    if args.sharded:
        (shard_wires, fabric), dt_shard = timed(
            lambda: sharded(params, cfg, wires, args.n_shards, dev, metrics, trace), dev)
        assert shard_wires == resp_wires, "sharded plane diverged from the batched plane"
        print(f"[sharded]    same burst over the fabric "
              f"({fabric.n_ranks - 1} shards, "
              f"{fabric.frames_routed} frames), token-identical, "
              f"in {dt_shard:.2f}s ({n_tok / dt_shard:.1f} tok/s)")

    # --- streaming plane: tokens surface per decode tick --------------
    if args.streaming:
        t0 = time.time()
        (stream_wires, fabric, arrivals), dt_stream = timed(
            lambda: streaming(params, cfg, wires, args.n_shards, dev, metrics, trace, t0), dev)
        assert stream_wires == resp_wires, "streaming plane diverged from the batched plane"
        print(f"[streaming]  same burst streamed per decode tick "
              f"({fabric.n_ranks - 1} shards, {len(arrivals)} token "
              f"events), byte-identical wires, "
              f"time-to-first-token {arrivals[0]:.3f}s vs "
              f"{dt_stream:.2f}s total "
              f"({n_tok / dt_stream:.1f} tok/s)")
        cc_wires = congestion_controlled(params, cfg, wires, args.n_shards, dev)
        assert cc_wires == resp_wires, "congestion-controlled streaming diverged"
        print("[streaming]  defect_after=2 + backpressure_p95=4.0: "
              "still byte-identical")

    # --- one-wire-at-a-time path, same burst --------------------------
    seq_wires, dt_seq = timed(lambda: sequential(params, cfg, wires, dev), dev)
    assert [decode_response(w) for w in seq_wires] == [
        decode_response(w) for w in resp_wires
    ], "sequential and batched paths disagree"
    print(f"[sequential] same burst, same tokens, in {dt_seq:.2f}s "
          f"({n_tok / dt_seq:.1f} tok/s) -> batched is {dt_seq / dt_batched:.1f}x")

    # --- telemetry artifacts (whichever fabric modes ran) --------------
    if metrics is not None:
        from repro_torch.obs import environment_meta

        snap = metrics.snapshot()
        snap["meta"] = environment_meta()
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=1)
        print(f"[obs]        wrote {args.metrics_json} "
              f"({len(snap['metrics'])} metrics)")
    if trace is not None:
        trace.save(args.trace_out)
        print(f"[obs]        wrote {args.trace_out} "
              f"({len(trace.events)} events)")


if __name__ == "__main__":
    main()
