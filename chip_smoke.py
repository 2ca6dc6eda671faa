#!/usr/bin/env python3
"""Chip smoke: drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

What it does, in order (any failed check raises and the exit code is 1):

1. Builds every CUDA source of the port with nvcc (``sm_90a``), all in
   parallel, and prints the card's name and power limit.
2. Kernels: each DES kernel (``unpack_run`` aligned and general,
   ``unpack_gather``) against its plain PyTorch version, bit for bit, at the
   calls the main paths make (recorded by the wrappers during one serve DES
   and one record decode) and at one large shape (a 256 MiB wire).
   Prints each kernel's time (CUDA events), its byte bound at the card's
   memory rate and its plain version's time.
3. Serve: ``repro_torch.launch.serve.serve_requests`` on yi-6b at full width
   and depth (bfloat16, seeded random weights): 16 request wires x 4
   prompts of 16-256 tokens, ``pad_to=256``, ``max_new=32``, 16 slots.  The
   kernel DES must equal the plain DES and the host DesFSM; every response
   wire must parse back with ``max_new`` tokens per prompt; the unpack
   kernels' launch counters must rise during the serve run.  The float32
   smoke model must serve the same bytes on the card and on the host.
4. Records: ``kernels.ops.decode_message_kernel`` on one wire of 2**20
   13-byte records (an unaligned uniform run): the general run kernel must
   launch, and the lanes must equal the record bytes.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import Schema, lanes_u32, plan_from_wire, ser_sw_to_hw  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import phit_unpack as pu  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import cached_serve_steps  # noqa: E402
from repro_torch.models import init_params, param_count  # noqa: E402
from repro_torch.models import prefill as model_prefill  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
SOURCE = "src/repro_torch/kernels/csrc/phit_unpack.cu"
KERNELS = {
    # name: (replaces, plain version, wrapper)
    "unpack_run_aligned": ("src/repro/kernels/phit_unpack.py:48",
                           pu.unpack_run_aligned_plain, pu.unpack_run_aligned),
    "unpack_run_general": ("src/repro/kernels/phit_unpack.py:57",
                           pu.unpack_run_general_plain, pu.unpack_run_general),
    "unpack_gather": ("src/repro/kernels/phit_unpack.py:143",
                      pu.unpack_gather_plain, pu.unpack_gather),
}

# serve load (phase 3)
N_REQUESTS, N_PROMPTS, PROMPT_LENS = 16, 4, (16, 257)
PAD_TO, MAX_NEW, SLOTS, SEED = 256, 32, 16, 0
# record path (phase 4): hdr Bytes 3 + Array<Bytes 13>
RECORD_SCHEMA = {"Recs": [["hdr", ["Bytes", 3]], ["recs", ["Array", ["Bytes", 13]]]]}
N_RECORDS = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back runs."""
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


def call_bytes(kernel: str, wire: torch.Tensor, args: tuple) -> int:
    """Bytes one call must move: the wire bytes its rows cover (read once,
    at most the whole wire), the offsets for the gather, the lanes written."""
    if kernel == "unpack_gather":
        offsets, nbytes = args
        rows = offsets.shape[0]
        extra = 8 * rows
    else:
        _, _, rows, nbytes = args
        extra = 0
    nlanes = (nbytes + 3) // 4
    read = min(4 * wire.shape[0], rows * nbytes)
    return read + extra + 4 * rows * nlanes


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over u32 lanes (0 when the two agree bit for bit)."""
    if a.numel() == 0:
        return 0
    d = (a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)
    return int(d.abs().max())


def measure(kernel: str, calls, reps: int) -> dict:
    """Hold a kernel to its plain version on ``calls`` (list of (wire,
    args)) and time both: one 'run' is every call in the list."""
    _, plain, wrapper = KERNELS[kernel]
    err = 0
    for wire, args in calls:
        before = pu.LAUNCHES[kernel]
        got = wrapper(wire, *args)
        torch.cuda.synchronize()
        check(pu.LAUNCHES[kernel] == before + 1, f"{kernel} did not launch")
        want = plain(wire, *args)
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want), f"{kernel} differs from its plain version")
    ms = time_ms(lambda: [wrapper(w, *a) for w, a in calls], reps)
    plain_ms = time_ms(lambda: [plain(w, *a) for w, a in calls], max(1, reps // 10))
    nbytes = sum(call_bytes(kernel, w, a) for w, a in calls)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}


def strided_and_ms(wire: torch.Tensor, args: tuple, reps: int) -> float:
    """One PyTorch call computing an aligned run: the strided view of the
    rows' words ANDed with the lane mask (the view and mask are inputs)."""
    base, stride, count, nbytes = args
    nlanes = (nbytes + 3) // 4
    mask = torch.tensor([(1 << 8 * (nbytes - 4 * j)) - 1 if nbytes - 4 * j < 4 else -1
                         for j in range(nlanes)], dtype=torch.int32, device=wire.device)
    view = torch.as_strided(wire, (count, nlanes), (stride // 4, 1), base // 4)
    check(torch.equal(torch.bitwise_and(view, mask), pu.unpack_run_aligned(wire, *args)),
          "strided view & mask differs from unpack_run_aligned")
    return time_ms(lambda: torch.bitwise_and(view, mask), reps)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def main_path_calls(dev, wires, rec_plan, rec_lanes):
    """The kernel calls the serve DES and the record path make, as the
    wrappers record them: kernel -> [(wire, args), ...]."""
    with pu.recording() as made:
        serve.decode_request_batch(wires, dev)
        ops.decode_message_kernel(rec_lanes, rec_plan)
    torch.cuda.synchronize()
    calls = {name: [] for name in KERNELS}
    for name, wire, args in made:
        calls[name].append((wire, args))
    for name, c in calls.items():
        check(len(c) >= 1, f"{name}: no call on the main paths")
    return calls


def record_wire(n: int, seed: int = 1):
    """One RECORD_SCHEMA wire of ``n`` random records, built with numpy
    (layout checked against ser_sw_to_hw on a small message)."""
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, 256, (n, 13), dtype=np.uint8)
    hdr = bytes([0xEF, 0xCD, 0xAB])
    wire = hdr + np.uint32(n).tobytes() + recs.tobytes()
    return wire, recs


def record_path(dev, rec_wire):
    """The record message's plan and lanes, its layout checked against
    ser_sw_to_hw on a small message."""
    schema = Schema.from_json(RECORD_SCHEMA)
    small, small_recs = record_wire(5, seed=2)
    msg = {"hdr": 0xABCDEF, "recs": [int.from_bytes(r.tobytes(), "little") for r in small_recs]}
    check(ser_sw_to_hw(schema, msg) == small, "record wire layout != ser_sw_to_hw")
    plan = plan_from_wire(schema, rec_wire)
    check(ops.runs_from_plan(plan, "recs.elem") == (7, 13), "records are not one run")
    return plan, ops.wire_to_u32(rec_wire, dev)


def phase_kernels(dev, main):
    """Phase 2: each kernel == plain at the main paths' calls and large."""
    rows = {}
    g = torch.Generator(device=dev).manual_seed(7)
    big = torch.randint(-2**31, 2**31, (1 << 26,), dtype=torch.int32, device=dev, generator=g)
    n_big = 4 * big.shape[0]
    large = {
        "unpack_run_aligned": [(big, (0, 4, 1 << 26, 4))],
        "unpack_run_general": [(big, (1, 13, (n_big - 1 - 13) // 13 + 1, 13))],
        "unpack_gather": [(big, (torch.sort(torch.randint(
            0, n_big - 4, (1 << 24,), device=dev, generator=g)).values, 4))],
    }
    for name in KERNELS:
        m = measure(name, main[name], reps=200)
        lg = measure(name, large[name], reps=20)
        m["library_ms"] = lg["library_ms"] = None
        if name == "unpack_run_aligned":
            m["library_ms"] = sum(strided_and_ms(w, a, 200) for w, a in main[name])
            lg["library_ms"] = strided_and_ms(*large[name][0], 20)
        rows[name] = {"main": m, "large": lg}
        for label, r in (("main-path shapes", m), ("large (256 MiB wire)", lg)):
            log(f"[kernels] {name:20s} {label:22s} kernel {r['ms']:.4f} ms  "
                f"bound {r['bound_ms']:.4f} ms ({r['bytes']} B)  plain {r['plain_ms']:.4f} ms"
                + (f"  strided view & mask {r['library_ms']:.4f} ms" if r["library_ms"] else "")
                + f"  max_abs_err {r['max_abs_err']}")
    del big, large
    torch.cuda.empty_cache()
    return rows


def phase_serve(dev, wires):
    """Phase 3: the serving plane at full width; returns per-path launches."""
    # DES: kernel on the card == plain on the host == host DesFSM
    des_card = serve.decode_request_batch(wires, dev)
    check(des_card == serve.decode_request_batch(wires, "cpu"), "kernel DES != plain DES")
    check(des_card == [serve.decode_request(w) for w in wires], "kernel DES != DesFSM DES")
    n_tok_in = sum(len(p) for _, ps in des_card for p in ps)
    log(f"[serve] DES: {len(wires)} wires, {sum(map(len, wires))} bytes, {n_tok_in} prompt "
        f"tokens; kernel == plain == DesFSM")

    # small-input reference: float32 smoke model, card vs host, same bytes
    scfg = smoke_config(get_config("yi-6b"))
    sp_cpu = init_params(scfg, torch.Generator().manual_seed(0), "cpu")
    sp_gpu = init_params(scfg, torch.Generator().manual_seed(0), "cpu").to(dev)
    swires = serve.synthetic_wires(scfg, 4, 3, seed=3)
    kw = dict(max_new=6, pad_to=16, slots=4)
    check(serve.serve_requests(sp_gpu, scfg, swires, device=dev, **kw)
          == serve.serve_requests(sp_cpu, scfg, swires, device="cpu", **kw),
          "smoke model: card and host responses differ")
    log("[serve] smoke yi-6b (float32): card responses byte-identical to the host's")
    del sp_cpu, sp_gpu

    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    log(f"[serve] yi-6b {cfg.n_layers}L d{cfg.d_model} {cfg.n_heads}H kv{cfg.n_kv} "
        f"ff{cfg.d_ff} vocab {cfg.vocab} {cfg.dtype}: {n_params} params "
        f"({2 * n_params / 2**30:.2f} GiB), init {time.perf_counter() - t0:.2f} s")

    # warm-up (allocator, cuBLAS handles) on two requests, then the counted run
    serve.serve_requests(params, cfg, wires[:2], max_new=2, pad_to=PAD_TO, slots=SLOTS,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pu.reset_launches()
    t0 = time.perf_counter()
    resp = serve.serve_requests(params, cfg, wires, max_new=MAX_NEW, pad_to=PAD_TO,
                                slots=SLOTS, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(pu.LAUNCHES)
    check(launches["unpack_run_aligned"] >= 1, "serve run launched no unpack_run_aligned")
    check(launches["unpack_gather"] >= 1, "serve run launched no unpack_gather")
    n_out = 0
    for m, (w, rw) in enumerate(zip(wires, resp)):
        rid, outs = serve.decode_response(rw)
        check(rid == m and len(outs) == N_PROMPTS, f"response {m}: bad header")
        for o in outs:
            check(len(o) == MAX_NEW and all(0 <= t < cfg.vocab for t in o),
                  f"response {m}: bad tokens")
            n_out += len(o)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] serve_requests: {len(wires)} requests, {n_out} tokens generated in "
        f"{dt:.3f} s: {len(wires) / dt:.3f} req/s, {n_out / dt:.1f} tok/s; peak "
        f"{peak:.2f} GiB; launches {launches}")

    # step times at the serve shapes
    prefill_step, decode_step = cached_serve_steps(cfg, cache_len=PAD_TO + MAX_NEW)
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(2, cfg.vocab, (SLOTS, PAD_TO), dtype=torch.int32, device=dev,
                         generator=g)
    pf_ms = time_ms(lambda: prefill_step(params, {"tokens": toks}), reps=3, warmup=1)
    tok, cache = prefill_step(params, {"tokens": toks})
    state = {"tok": tok, "cache": cache}

    def one_decode():
        state["tok"], state["cache"] = decode_step(params, state["cache"], state["tok"])

    dec_ms = time_ms(one_decode, reps=20, warmup=2)
    with torch.no_grad():
        logits, _ = model_prefill(params, cfg, {"tokens": toks[:2]}, last_only=True)
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (2, 1, cfg.padded_vocab),
          "full-width prefill logits not finite / wrong shape")
    log(f"[serve] prefill step ({SLOTS}x{PAD_TO} tokens): {pf_ms:.3f} ms; decode step "
        f"({SLOTS} slots, cache {PAD_TO + MAX_NEW}): {dec_ms:.3f} ms")
    del params, cache, state
    torch.cuda.empty_cache()
    return launches


def phase_records(plan, lanes, rec_wire, recs):
    """Phase 4: one large fixed-width record message through
    decode_message_kernel; returns its launches."""
    pu.reset_launches()
    out = ops.decode_message_kernel(lanes, plan)
    torch.cuda.synchronize()
    launches = dict(pu.LAUNCHES)
    check(launches["unpack_run_general"] >= 1, "record path launched no unpack_run_general")
    want = np.zeros((len(recs), 16), np.uint8)
    want[:, :13] = recs
    check(np.array_equal(lanes_u32(out["recs.elem"]), want.view(np.uint32)),
          "record lanes differ from the record bytes")
    check(int(lanes_u32(out["hdr"])[0, 0]) == 0xABCDEF, "record header differs")
    log(f"[records] decode_message_kernel: {len(recs)} records of 13 bytes "
        f"({len(rec_wire)} B wire) decoded; launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (so, text) in built.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}.cu -> {so.name} in {time.perf_counter() - t0:.1f} s; "
            + "; ".join(regs))

    wires = serve.synthetic_wires(get_config("yi-6b"), N_REQUESTS, N_PROMPTS, SEED,
                                  *PROMPT_LENS)
    rec_wire, recs = record_wire(N_RECORDS)
    rec_plan, rec_lanes = record_path(dev, rec_wire)
    rows = phase_kernels(dev, main_path_calls(dev, wires, rec_plan, rec_lanes))
    path_launches = [phase_serve(dev, wires),
                     phase_records(rec_plan, rec_lanes, rec_wire, recs)]

    records = []
    for name, (replaces, _, _) in KERNELS.items():
        n = sum(p[name] for p in path_launches)
        check(n >= 1, f"{name} was not launched on any main path")
        m = rows[name]["main"]
        records.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": n, "max_abs_err": max(m["max_abs_err"],
                                              rows[name]["large"]["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "bytes", "library_ms": m["library_ms"],
        })
    log(f"[card] {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
