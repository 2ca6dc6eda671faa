#!/usr/bin/env python3
"""B6, the RX split (``kernels.frame_pack.unpack_frames_batch``), on one card:
variants of its kernel against each other, against the two ``.contiguous()``
slices that compute the same function and, with ``--baseline``, against the
``hgum_unpack_frames_batch`` of another copy of ``csrc/frame_pack.cu``.

    python3 scripts/b6_variants.py [--baseline OTHER/frame_pack.cu] [--rounds 21]
                                   [--out experiments/b6_variants.json]

``shipped`` is ``src/repro_torch/kernels/csrc/frame_pack.cu`` as the port
builds it.  A variant is ``scripts/b6_variants.cu``, the same split body
with build-time knobs, built with ``-DHGUM_SPLIT_UNROLL_PHITS``,
``_UNROLL_WORDS`` (units in flight a thread), ``_STREAMING`` (``__ldcs`` /
``__stcs``) and ``_BLOCKS_PER_SM`` (a capped grid that strides).
Shapes: 2**20 frames of 4 + 64 words (whole phits), of 4 + 63 words, and
of 4 + 64 words at a storage offset of one word (the last two take the word
form).  Every variant is held to the slices bit for bit at each shape
first; then ``--rounds`` rounds of ``--reps`` calls each, the order rotated
every round, give each one's median time, its share of the byte bound (the
frames read once, headers and payloads written once, at 3.35 TB/s) and its
ratio to the slices round by round.

Then the wrapper itself at the sharded path's calls (frames of (384, 68)
and (640, 68), twice each, as ``chip_smoke.py`` phase 6 records them): its
two outputs as views of one buffer (shipped) against the same wrapper with
two ``torch.empty`` calls, and the slices.  These calls are launch-bound, so each round takes
CUDA events over back-to-back calls and the host clock per call.

Prints the card's name and power limit and writes every figure to
``--out`` (JSON).  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import frame_pack as fp  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
SOURCE = _build.CSRC / "frame_pack.cu"
VARIANT_SOURCE = Path(__file__).resolve().with_suffix(".cu")
KNOBS = ("UNROLL_PHITS", "UNROLL_WORDS", "STREAMING", "BLOCKS_PER_SM")
#: knob values to try; U units in flight a thread, the same U for both forms
VARIANTS = ([dict(UNROLL_PHITS=u, UNROLL_WORDS=u, STREAMING=s, BLOCKS_PER_SM=b)
             for b in (8, 0) for u in (1, 2, 4) for s in (0, 1)]
            + [dict(UNROLL_PHITS=u, UNROLL_WORDS=u, STREAMING=0, BLOCKS_PER_SM=b)
               for u in (1, 2) for b in (16, 32)]
            + [dict(UNROLL_PHITS=4, UNROLL_WORDS=4, STREAMING=0, BLOCKS_PER_SM=4)])
N_FRAMES = 1 << 20
PATH_CALLS = ((384, 68), (640, 68), (384, 68), (640, 68))


def variant_name(knobs: dict) -> str:
    return (f"U={knobs['UNROLL_PHITS']}/{knobs['UNROLL_WORDS']} "
            f"{'ldcs/stcs' if knobs['STREAMING'] else 'ldg'} "
            f"{knobs['BLOCKS_PER_SM'] or 'all'} blocks/SM")


def build(libs: dict, out_dir: Path) -> dict:
    """name -> (source, -D flags) built with nvcc, all at once; returns
    name -> (loaded library, ptxas lines of the split kernels)."""
    procs = {}
    for i, (name, (src, defines)) in enumerate(libs.items()):
        so = out_dir / f"libsplit{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs, entry = [], None
        for ln in log.splitlines():  # each split kernel's registers and spills
            if "Compiling entry function" in ln:
                entry = ln if ("split" in ln or "unpack" in ln) else None
            elif entry and ("registers" in ln or "spill" in ln):
                regs.append(ln.strip())
        lib = ctypes.CDLL(str(so))
        lib.hgum_unpack_frames_batch.argtypes = fp._SIGNATURES["hgum_unpack_frames_batch"]
        lib.hgum_unpack_frames_batch.restype = ctypes.c_int
        out[name] = (lib, regs)
    return out


def splitter(lib):
    def split(frames):
        rows, width = frames.shape
        out = torch.empty(rows * width, dtype=torch.int32, device=frames.device)
        hdr = out[:rows * fp.HDR_WORDS].view(rows, fp.HDR_WORDS)
        pay = out[rows * fp.HDR_WORDS:].view(rows, width - fp.HDR_WORDS)
        rc = lib.hgum_unpack_frames_batch(frames.data_ptr(), hdr.data_ptr(), pay.data_ptr(),
                                          rows, width - fp.HDR_WORDS, fp._stream(frames))
        if rc != 0:
            raise RuntimeError(f"hgum_unpack_frames_batch failed ({rc})")
        return hdr, pay
    return split


def slices(frames):
    return frames[:, :fp.HDR_WORDS].contiguous(), frames[:, fp.HDR_WORDS:].contiguous()


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    dt = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return dt / reps / 1e3


def rounds(entries: dict, rounds_n: int, measure) -> dict:
    """name -> [one measurement a round]; the order rotates every round."""
    names = list(entries)
    out = {n: [] for n in names}
    for r in range(rounds_n):
        k = r % len(names)
        for n in names[k:] + names[:k]:
            out[n].append(measure(entries[n]))
    return out


def summary(times: list, ref: list, bound_ms: float | None = None) -> dict:
    ratios = sorted(t / b for t, b in zip(times, ref))
    row = {"median_ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times),
           "ratio_to_slices_median": statistics.median(ratios), "ratio_min": ratios[0],
           "ratio_max": ratios[-1], "rounds_faster_than_slices": sum(x < 1 for x in ratios),
           "rounds": len(times)}
    if bound_ms is not None:
        row["share_of_bound"] = bound_ms / row["median_ms"]
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="another frame_pack.cu to time beside")
    ap.add_argument("--rounds", type=int, default=21)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path, default=ROOT / "experiments" / "b6_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b6_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda")

    libs = {"shipped (U=1/4 ldg all blocks/SM)": (SOURCE, [])}
    for v in VARIANTS:
        libs[variant_name(v)] = (VARIANT_SOURCE, [f"-DHGUM_SPLIT_{k}={v[k]}" for k in KNOBS])
    if args.baseline:
        libs[f"baseline {args.baseline}"] = (args.baseline.resolve(), [])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        built = build(libs, Path(tmp))
        print(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
        for name, (_, regs) in built.items():
            print(f"[build] {name}: " + "; ".join(regs), flush=True)
        split = {name: splitter(lib) for name, (lib, _) in built.items()}

        g = torch.Generator(device=dev).manual_seed(11)
        full = torch.randint(-2**31, 2**31, (1 + N_FRAMES * 68,), dtype=torch.int32,
                             device=dev, generator=g)
        shapes = {"2**20 x (4 + 64)": full[:N_FRAMES * 68].view(N_FRAMES, 68),
                  "2**20 x (4 + 63)": full[:N_FRAMES * 67].view(N_FRAMES, 67),
                  "2**20 x (4 + 64) at +1 word": full[1:].view(N_FRAMES, 68)}
        result = {"card": card, "rounds": args.rounds, "reps": args.reps, "large": {},
                  "path": {}}
        for label, frames in shapes.items():
            want = slices(frames)
            for name, fn in split.items():
                got = fn(frames)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} differs from the slices at {label}")
            del want, got
            bound_ms = 2 * 4 * frames.numel() / HBM_BYTES_PER_S * 1e3
            entries = {**{n: (lambda f=f, x=frames: f(x)) for n, f in split.items()},
                       "slices .contiguous()": lambda x=frames: slices(x)}
            times = rounds(entries, args.rounds, lambda fn: time_ms(fn, args.reps))
            ref = times["slices .contiguous()"]
            rows = {n: summary(t, ref, bound_ms) for n, t in times.items()}
            result["large"][label] = {"bound_ms": bound_ms, "rows": rows}
            print(f"[large] {label}: bound {bound_ms:.4f} ms ({2 * 4 * frames.numel()} B); "
                  f"{args.rounds} rounds of {args.reps} calls, all == slices", flush=True)
            for n, r in sorted(rows.items(), key=lambda kv: kv[1]["median_ms"]):
                print(f"[large]   {n:45s} median {r['median_ms']:.4f} ms (min {r['min_ms']:.4f}, "
                      f"max {r['max_ms']:.4f})  {100 * r['share_of_bound']:.1f} % of bound  "
                      f"/ slices {r['ratio_to_slices_median']:.4f} "
                      f"({r['ratio_min']:.4f}-{r['ratio_max']:.4f}), faster in "
                      f"{r['rounds_faster_than_slices']} of {r['rounds']}", flush=True)
        del full, shapes
        torch.cuda.empty_cache()

        # the wrapper at the sharded path's calls: one buffer against two
        calls = [torch.randint(-2**31, 2**31, s, dtype=torch.int32, device=dev, generator=g)
                 for s in PATH_CALLS]
        def two_empty(frames):
            """``fp.unpack_frames_batch`` on the card with two outputs of
            their own."""
            if frames.dim() != 2 or frames.shape[1] < fp.HDR_WORDS:
                raise ValueError(f"frames must be (N, 4 + frame_words), got {frames.shape}")
            fp._on_cpu(frames)
            rows, width = frames.shape
            if rows * width > fp._MAX_WORDS:
                raise ValueError(f"{rows} frames of {width} words exceed one launch")
            frames = frames.contiguous()
            fw = width - fp.HDR_WORDS
            hdr = torch.empty((rows, fp.HDR_WORDS), dtype=torch.int32, device=frames.device)
            pay = torch.empty((rows, fw), dtype=torch.int32, device=frames.device)
            if rows:
                fp._launch("unpack_frames_batch", (frames,), "hgum_unpack_frames_batch",
                           frames.data_ptr(), hdr.data_ptr(), pay.data_ptr(), rows, fw,
                           fp._stream(frames))
            return hdr, pay

        entries = {"wrapper, one buffer (shipped)":
                   lambda: [fp.unpack_frames_batch(f) for f in calls],
                   "wrapper, two torch.empty": lambda: [two_empty(f) for f in calls],
                   "slices .contiguous()": lambda: [slices(f) for f in calls]}
        check = [fn() for fn in entries.values()]
        torch.cuda.synchronize()
        for got in check[:2]:
            if not all(torch.equal(a, b) for x, y in zip(got, check[2]) for a, b in zip(x, y)):
                raise AssertionError("wrapper differs from the slices at the path's calls")
        dev_ms = rounds(entries, args.rounds, lambda fn: time_ms(fn, 200))
        host = rounds(entries, args.rounds, lambda fn: host_us(fn, 200) / len(calls))
        ref = dev_ms["slices .contiguous()"]
        for n in entries:
            row = summary(dev_ms[n], ref)
            row["host_us_per_call_median"] = statistics.median(host[n])
            result["path"][n] = row
            print(f"[path] {n:32s} {len(calls)} calls {[tuple(f.shape) for f in calls]}: "
                  f"events median {row['median_ms']:.4f} ms (min {row['min_ms']:.4f}, max "
                  f"{row['max_ms']:.4f}), host {row['host_us_per_call_median']:.2f} us a call; "
                  f"/ slices {row['ratio_to_slices_median']:.4f}, faster in "
                  f"{row['rounds_faster_than_slices']} of {row['rounds']}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"[card] {card}; figures in {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
