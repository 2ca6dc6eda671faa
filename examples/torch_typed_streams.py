"""Typed streams end to end on the PyTorch/CUDA port: a second
``Stream<T>`` payload over the fabric.

The twin of ``examples/typed_streams.py`` on ``repro_torch``.  The token
chunks of the streaming serve plane are generated from a
``Stream<Bytes 4>`` schema declaration (``repro_torch.stream.chunks``);
the shipped second typed stream, per-token log-probabilities, is declared
in schema JSON alone as ``Stream<Struct{tok, logprob}>``.  Two gates:

1. **golden byte-compat**: the generated token codec, packed on the card
   by B7's fragment kernel, emits byte for byte the frozen wire format
   (``tests/golden/token_chunks.bin``);
2. **token identity**: attaching the logprob stream changes nothing about
   the token plane: the streamed final wires stay byte-identical to the
   batched plane and to the logprob-free streamed run, while every
   ``on_logprob`` event's token cross-validates against ``on_token``.

On one card the ranks are a tensor axis: the streamed serve runs on the
8-rank fabric (7 shards) the reference gets under the README's 8 simulated
devices, with no XLA_FLAGS.

Run:  PYTHONPATH=src python examples/torch_typed_streams.py [--device cpu]

It runs on the CUDA card unless given ``--device cpu``; without a card and
without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import DeviceLike, default_device
from repro_torch.launch.serve import (
    encode_request, serve_requests, serve_requests_streaming,
)
from repro_torch.models import init_params
from repro_torch.stream import (
    LOGPROB_STREAM_SCHEMA_JSON, TokenChunk, encode_chunk_burst,
    logprob_stream_plan,
)

MAX_NEW = 6
PAD_TO = 16
N_LAYERS = 2
GOLDEN = pathlib.Path(__file__).parent.parent / "tests" / "golden" \
    / "token_chunks.bin"


def golden_chunks():
    """The chunks the golden fixture holds (seed 1801)."""
    rng = np.random.default_rng(1801)
    specs = [
        (0x0001_0000, 1, False), (0xFFFF_FFFF, 0, False), (7, 0, True),
        (0x0002_0003, 13, False), (42, 16, True), (0x1234_5678, 250, False),
    ]
    chunks, step_per_sid = [], {}
    for sid, n, eos in specs:
        step = step_per_sid.get(sid, 0)
        toks = tuple(
            int(t) for t in rng.integers(0, 1 << 32, n, dtype=np.uint64)
        )
        chunks.append(TokenChunk(sid, step, toks, eos))
        step_per_sid[sid] = step + 1
    return chunks


def check_golden_fixture(device: DeviceLike = None) -> bytes:
    """The generated ``Stream<Bytes 4>`` codec vs the frozen wire bytes."""
    chunks = golden_chunks()
    golden = GOLDEN.read_bytes()
    got = encode_chunk_burst(chunks, default_device(device))
    assert got == golden, \
        "generated token codec diverged from the frozen golden fixture"
    print(f"[golden]     generated codec byte-identical to "
          f"{GOLDEN.name} ({len(golden)} B, {len(chunks)} chunks)")
    return got


def burst(cfg):
    """4 request wires of 1-2 prompts of PAD_TO tokens (seed 0)."""
    rng = np.random.default_rng(0)
    return [
        encode_request(r, [
            list(map(int, rng.integers(2, cfg.vocab, PAD_TO)))
            for _ in range(int(rng.integers(1, 3)))
        ])
        for r in range(4)
    ]


def streamed_logprobs(params, cfg, wires, device: DeviceLike) -> Dict:
    """The batched plane, the streamed plane and the streamed plane with the
    logprob stream attached; returns their wires and the streams' events."""
    kw = dict(max_new=MAX_NEW, pad_to=PAD_TO, slots=8, device=device)
    batched = serve_requests(params, cfg, wires, **kw)
    plain = serve_requests_streaming(params, cfg, wires, **kw)
    toks, lps = {}, {}
    t0 = time.time()
    with_lp = serve_requests_streaming(
        params, cfg, wires, logprobs=True,
        on_token=lambda m, j, s, t: toks.setdefault((m, j), []).append(t),
        on_logprob=lambda m, j, s, t, lp:
            lps.setdefault((m, j), []).append((t, lp)),
        **kw)
    return {"batched": batched, "plain": plain, "with_lp": with_lp, "toks": toks,
            "lps": lps, "seconds": time.time() - t0}


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    check_golden_fixture(dev)

    plan = logprob_stream_plan()
    print(f"[plan]       logprob stream from schema JSON alone: "
          f"{list(LOGPROB_STREAM_SCHEMA_JSON)} -> "
          f"{plan.n_leaves} leaves x {plan.elem_words} word(s)/element")

    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")), n_layers=N_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = streamed_logprobs(params, cfg, burst(cfg), dev)
    assert out["plain"] == out["batched"], "streaming diverged from the batched plane"
    assert out["with_lp"] == out["plain"], \
        "attaching the logprob stream changed the token plane"
    toks, lps = out["toks"], out["lps"]
    assert set(lps) == set(toks), "logprob/token stream key mismatch"
    n_events = 0
    for key, pairs in lps.items():
        assert [t for t, _ in pairs] == toks[key], \
            f"logprob stream tokens diverged for {key}"
        assert all(np.isfinite(lp) and lp <= 0.0 for _, lp in pairs)
        n_events += len(pairs)
    sample = lps[min(lps)][0]
    print(f"[logprobs]   {n_events} logprob events over "
          f"{len(lps)} streams in {out['seconds']:.2f}s on {dev}; tokens byte-identical "
          f"with and without the extra stream; sample (tok={sample[0]}, "
          f"lp={sample[1]:.4f})")
    return {"plan": plan, **out}


if __name__ == "__main__":
    main()
