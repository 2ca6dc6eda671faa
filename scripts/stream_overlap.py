#!/usr/bin/env python3
"""What the streaming plane's fabric/compute overlap buys on one CUDA card.

    python3 scripts/stream_overlap.py [--reps 2]

Serves ``chip_smoke.py``'s load (yi-6b at full width and depth, bfloat16,
seeded random weights; 16 request wires x 4 prompts of 16-256 tokens,
``pad_to=256``, ``max_new=32``, 16 slots) through
``repro_torch.launch.serve.serve_requests_streaming`` on 3 shards (default
placement, ARQ on, no logprobs) in four variants:

* ``overlap=True`` and ``overlap=False``;
* each with the fused fabric tick's outputs staged into pinned host memory
  behind a CUDA event (``Fabric._stage``, the port's default), and
  unstaged: ``poll`` then reads the outputs back with ``.cpu()`` on the
  stream, behind any decode step queued after the tick.

The variants run in turns (staged, unstaged, unstaged, staged per overlap
mode, ``--reps`` times), so drift on the card hits both alike.  Every run's
wires must equal the batched plane's.  For each run it prints the wall
time, fabric ticks, the host time per tick spent in ``Fabric.poll``, in
``Fabric.exchange_async`` and in the batchers' ``step_finish`` (the one
host sync per tick), and the median time to first token.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fabric.mailbox import Fabric  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatcher  # noqa: E402

N_REQUESTS, N_PROMPTS, PROMPT_LENS = 16, 4, (16, 257)
PAD_TO, MAX_NEW, SLOTS, SEED, N_SHARDS = 256, 32, 16, 0, 3

STAGE = Fabric._stage


def unstaged(self, out):
    """The tick's outputs stay on the device; ``_complete`` copies them
    back with ``.cpu()`` on the stream."""
    return (None,) + tuple(out)


class Timers:
    """Host seconds spent in the wrapped calls, per name."""

    def __init__(self):
        self.s = {"poll": [], "exchange_async": [], "step_finish": []}

    def wrap(self, obj, name):
        inner = getattr(obj, name)
        acc = self.s[name]

        def timed(*a, **k):
            t = time.perf_counter()
            out = inner(*a, **k)
            acc.append(time.perf_counter() - t)
            return out

        setattr(obj, name, timed)


def run(params, cfg, wires, base, overlap: bool, staged: bool) -> dict:
    Fabric._stage = STAGE if staged else unstaged
    fab = serve.default_serve_fabric(N_SHARDS, device="cuda")
    timers = Timers()
    timers.wrap(fab, "poll")
    timers.wrap(fab, "exchange_async")
    finish = ContinuousBatcher.step_finish

    def step_finish(self):
        t = time.perf_counter()
        out = finish(self)
        timers.s["step_finish"].append(time.perf_counter() - t)
        return out

    ContinuousBatcher.step_finish = step_finish
    first = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        resp = serve.serve_requests_streaming(
            params, cfg, wires, max_new=MAX_NEW, pad_to=PAD_TO, slots=SLOTS, fabric=fab,
            overlap=overlap, device="cuda",
            on_token=lambda m, j, s, t: first.setdefault((m, j), time.perf_counter()))
        torch.cuda.synchronize()
    finally:
        ContinuousBatcher.step_finish = finish
        Fabric._stage = STAGE
    dt = time.perf_counter() - t0
    if resp != base:
        raise AssertionError("streamed wires differ from the batched plane's")
    ticks = fab.ticks
    per_tick = {k: 1e3 * sum(v) / ticks for k, v in timers.s.items()}
    return {"s": dt, "ticks": ticks, "ttft_p50": statistics.median(
        t - t0 for t in first.values()), **{f"{k}_ms": v for k, v in per_tick.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_overlap: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    cfg = get_config("yi-6b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    wires = serve.synthetic_wires(cfg, N_REQUESTS, N_PROMPTS, SEED, *PROMPT_LENS)
    base = serve.serve_requests(params, cfg, wires, max_new=MAX_NEW, pad_to=PAD_TO,
                                slots=SLOTS, device="cuda")
    serve.serve_requests_streaming(params, cfg, wires[:2], max_new=2, pad_to=PAD_TO,
                                   slots=SLOTS, n_shards=N_SHARDS, device="cuda")  # warm-up
    rows = {}
    for _ in range(args.reps):
        for overlap in (True, False):
            for staged in (True, False, False, True):
                r = run(params, cfg, wires, base, overlap, staged)
                rows.setdefault((overlap, staged), []).append(r)
                print(f"[run] overlap={overlap!s:5} staged={staged!s:5} wall {r['s']:.3f} s, "
                      f"{r['ticks']} ticks, per tick: poll {r['poll_ms']:.3f} ms, "
                      f"exchange_async {r['exchange_async_ms']:.3f} ms, step_finish "
                      f"{r['step_finish_ms']:.3f} ms; TTFT p50 {r['ttft_p50']:.3f} s",
                      flush=True)
    for (overlap, staged), rs in rows.items():
        mean = {k: statistics.mean(r[k] for r in rs) for k in rs[0]}
        print(f"[mean] overlap={overlap!s:5} staged={staged!s:5} ({len(rs)} runs) wall "
              f"{mean['s']:.3f} s; per tick: poll {mean['poll_ms']:.3f} ms, exchange_async "
              f"{mean['exchange_async_ms']:.3f} ms, step_finish {mean['step_finish_ms']:.3f} "
              f"ms; TTFT p50 {mean['ttft_p50']:.3f} s")
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
