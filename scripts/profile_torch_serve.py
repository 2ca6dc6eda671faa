#!/usr/bin/env python3
"""Where the time goes in the port's serving plane, on one CUDA card.

    python3 scripts/profile_torch_serve.py

Profiles (``torch.profiler``, CPU + CUDA activity) the three device phases
of ``repro_torch.launch.serve.serve_requests`` at yi-6b full width and
depth in bfloat16, at the load ``chip_smoke.py`` serves (16 slots, prompts
padded to 256, cache 288):

* the DES payload pass (``decode_request_batch``) of the 16 request wires;
* one admit prefill step (16 x 256 tokens);
* one batched decode step (16 slots).

For each it prints the host wall time, the summed device time of every
kernel, their ratio (the device's busy share), the number of kernel
launches, and the ten kernels with the most device time.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import cached_serve_steps  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

SLOTS, PAD_TO, MAX_NEW = 16, 256, 32


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled(label: str, fn, reps: int = 3) -> None:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels) / reps
    print(f"[{label}] wall {wall_us / 1e3:.3f} ms/call, device {dev_us / 1e3:.3f} ms/call, "
          f"busy {dev_us / wall_us:.3f}, kernel launches {len(kernels) / reps:.0f}/call")
    top = sorted(prof.key_averages(), key=_device_us, reverse=True)[:10]
    for e in top:
        if _device_us(e) > 0:
            print(f"    {_device_us(e) / reps / 1e3:9.3f} ms  {e.count // reps:5d}x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"[card] {card}; torch {torch.__version__}")
    dev = torch.device("cuda")
    cfg = get_config("yi-6b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    wires = serve.synthetic_wires(cfg, 16, 4, seed=0, min_len=16, max_len=257)
    profiled("DES decode_request_batch x16 wires", lambda: serve.decode_request_batch(wires, dev))

    prefill_step, decode_step = cached_serve_steps(cfg, cache_len=PAD_TO + MAX_NEW)
    toks = torch.randint(2, cfg.vocab, (SLOTS, PAD_TO), dtype=torch.int32, device=dev)
    profiled(f"prefill step {SLOTS}x{PAD_TO}", lambda: prefill_step(params, {"tokens": toks}))
    tok, cache = prefill_step(params, {"tokens": toks})
    state = {"tok": tok, "cache": cache}

    def one_decode():
        state["tok"], state["cache"] = decode_step(params, state["cache"], state["tok"])

    profiled(f"decode step {SLOTS} slots", one_decode, reps=5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
