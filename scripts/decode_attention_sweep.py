#!/usr/bin/env python3
"""The decode-attention kernel (``kernels.decode_attention``) on one card:
its build, ``chip_smoke.py``'s phase 17 (kernel == plain at the cells'
calls and every family's heads, a CUDA graph replay, times at the cells'
calls), then a sweep of the key-split rule's one constant,
``BLOCKS_PER_SM``, at the cells' calls, at the MQA and MHA families' and
at the cells' heads with 8 rows (where the rule splits the keys).

    python3 scripts/decode_attention_sweep.py [--reps 100] [--out FILE.json]

Each row of the sweep gives the plan (head groups, splits, keys a split),
the kernel's time (CUDA events over ``--reps`` back-to-back calls), its
share of the byte bound (K and V below each row's kv_len read once, at
3.35 TB/s) and its float32 rate.  Prints the card's name and power limit;
writes every figure to ``--out``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

SWEEP = (1, 2, 4, 8, 16)


def sweep_cases() -> list:
    b, t = cs.DECODE_ATTN_FAMILY
    fam = [c for c in cs.decode_attn_cases() if c[0] in ("granite-34b", "stablelm-3b")]
    small = [(c[0] + " x8 rows", 8) + c[2:] for c in cs.DECODE_ATTN_CELLS]
    return list(cs.DECODE_ATTN_CELLS) + [(c[0], 8 * b, 2 * t) + c[3:] for c in fam] + small


def run_sweep(dev, card: str, reps: int, n_sm: int) -> list:
    g = torch.Generator(device=dev).manual_seed(29)
    out = []
    for case in sweep_cases():
        x = cs.decode_attn_inputs(case, dev, g, pos=case[2] - 41)
        for bps in SWEEP:
            with mock.patch.object(da, "BLOCKS_PER_SM", bps):
                plan = da.plan(case[1], case[3], case[4], case[2], n_sm)
                kern = cs.decode_attn_clone(x)
                ms = cs.time_ms(lambda: da.append_and_attend(**kern), reps)
            bound = cs.decode_attn_bytes(case, x) / cs.HBM_BYTES_PER_S * 1e3
            gflops = cs.decode_attn_flops(case, x) / ms / 1e6
            out.append({"case": case[0], "shape": case[1:6],
                        "blocks_per_sm": bps, "plan": plan, "ms": ms, "bound_ms": bound})
            cs.log(f"[sweep] {card} | {case[0]} {case[1:6]} BLOCKS_PER_SM {bps:2d} "
                   f"splits {plan['n_splits']} x {plan['split_len']}: {ms:.4f} ms, "
                   f"{100 * bound / ms:.1f} % of {bound:.4f} ms, {gflops:.0f} GFLOP/s")
        del x
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_attention_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    so, text = _build.build_all(["decode_attention"])["decode_attention"]
    cs.log(f"[build] decode_attention.cu -> {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"[build] {line.strip()}")

    rows = cs.phase_decode_attention(dev, card)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    sweep = run_sweep(dev, card, args.reps, n_sm)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows, "sweep": sweep},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
