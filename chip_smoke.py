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
5. Fabric: the same seeded sends (ARQ on, under a seeded FaultPlan)
   through both tick engines on the card and through the host fabric must
   deliver the same bytes, arrival steps and counters.
6. Sharded: ``serve_requests_sharded`` on the same yi-6b parameters and
   the same 16 wires, 3 shards, ARQ on, once with the default placement
   and once round-robin over the shards: every response must equal the
   batched plane's from phase 3, and the frame kernels' launch counters
   must rise.  Prints req/s, tok/s, fabric ticks, router scan steps per
   tick and host ms per tick.
7. Streaming: ``serve_requests_streaming`` on the same parameters and
   wires, 3 shards, default placement (by sequence weight), ARQ on, once
   with ``overlap=True, logprobs=True`` and once with ``overlap=False,
   logprobs=False``: the final wires must equal the batched plane's, every
   stream's ``on_token`` tokens in step order that sequence's output, the
   logprob stream's tokens the token stream's, and every logprob must be
   finite and <= 0; the B7 launch counter must rise.  Prints req/s, tok/s,
   TTFT per stream (p50, p95, max), fabric ticks, host ms per tick, the
   ``poll()`` wait per tick, B7 launches and requests per shard.
8. Frame kernels: ``pack_frames_batch`` and ``unpack_frames_batch``
   against their plain versions, bit for bit, at the calls phase 6 made
   (recorded by the wrappers) and at one large shape (2**20 frames of 68
   words, 272 MiB), with their times, bounds and plain and library times.
9. Fragment kernel: ``pack_chunks_batch`` (B7) against its plain version,
   bit for bit, at the calls phase 7 made (recorded) and at two large
   shapes (2**20 fragments x cap 64, one word each, and 2**19 x cap 32,
   two words each, seeded counts 0..cap; masked, and the first unmasked
   too), with its times, bound and plain and library times.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import statistics
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
from repro_torch.fabric import Fabric, FabricConfig, FaultPlan  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import frame_pack as fp  # noqa: E402
from repro_torch.kernels import phit_unpack as pu  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import cached_serve_steps  # noqa: E402
from repro_torch.models import init_params, param_count  # noqa: E402
from repro_torch.models import prefill as model_prefill  # noqa: E402
from repro_torch.obs.metrics import window_stats  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
PHIT_SOURCE = "src/repro_torch/kernels/csrc/phit_unpack.cu"
FRAME_SOURCE = "src/repro_torch/kernels/csrc/frame_pack.cu"
KERNELS = {
    # name: (source, replaces, plain version, wrapper, launch counters)
    "unpack_run_aligned": (PHIT_SOURCE, "src/repro/kernels/phit_unpack.py:48",
                           pu.unpack_run_aligned_plain, pu.unpack_run_aligned, pu.LAUNCHES),
    "unpack_run_general": (PHIT_SOURCE, "src/repro/kernels/phit_unpack.py:57",
                           pu.unpack_run_general_plain, pu.unpack_run_general, pu.LAUNCHES),
    "unpack_gather": (PHIT_SOURCE, "src/repro/kernels/phit_unpack.py:143",
                      pu.unpack_gather_plain, pu.unpack_gather, pu.LAUNCHES),
    "pack_frames_batch": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:82",
                          fp.pack_frames_batch_plain, fp.pack_frames_batch, fp.LAUNCHES),
    "unpack_frames_batch": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:168",
                            fp.unpack_frames_batch_plain, fp.unpack_frames_batch,
                            fp.LAUNCHES),
    "pack_chunks_batch": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:118",
                          fp.pack_chunks_batch_plain, fp.pack_chunks_batch, fp.LAUNCHES),
}
FRAME_KERNELS = ("pack_frames_batch", "unpack_frames_batch")

# serve load (phase 3)
N_REQUESTS, N_PROMPTS, PROMPT_LENS = 16, 4, (16, 257)
PAD_TO, MAX_NEW, SLOTS, SEED = 256, 32, 16, 0
# record path (phase 4): hdr Bytes 3 + Array<Bytes 13>
RECORD_SCHEMA = {"Recs": [["hdr", ["Bytes", 3]], ["recs", ["Array", ["Bytes", 13]]]]}
N_RECORDS = 1 << 20
# sharded plane (phase 6) and the frame kernels' large shape (phase 8)
N_SHARDS = 3
N_FRAMES_LARGE, FRAME_WORDS = 1 << 20, 64
# the fragment kernel's large shapes (phase 9): (fragments, cap, elem_words)
CHUNK_LARGE = ((1 << 20, 64, 1), (1 << 19, 32, 2))


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


def call_bytes(kernel: str, wire: torch.Tensor, *args) -> int:
    """Bytes one call must move.  Unpack kernels: the wire bytes their rows
    cover (read once, at most the whole wire), the offsets for the gather,
    the lanes written.  Frame kernels: every input word read once and
    every output word written once, i.e. twice the inputs' bytes."""
    if kernel in FRAME_KERNELS:
        return 2 * 4 * sum(t.numel() for t in (wire,) + args)
    if kernel == "pack_chunks_batch":
        # meta and counts read, every row written; element words read only
        # where they are live (the masked form reads no word past the count)
        tokens, counts, elem_words = args
        rows, cap_w = tokens.shape
        if elem_words:
            live = int(torch.clamp(counts.long() * elem_words, max=cap_w).sum())
        else:
            live = rows * cap_w
        return 4 * (wire.numel() + counts.numel() + live + rows * (cap_w + 4))
    args = tuple(args)
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


def max_abs_err(a, b) -> int:
    """Largest |a - b| over u32 lanes (0 when the two agree bit for bit);
    a tuple of outputs counts its worst part."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.numel() == 0:
        return 0
    d = (a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)
    return int(d.abs().max())


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def measure(kernel: str, calls, reps: int) -> dict:
    """Hold a kernel to its plain version on ``calls`` (list of argument
    tuples) and time both: one 'run' is every call in the list."""
    _, _, plain, wrapper, launches = KERNELS[kernel]
    err = 0
    for args in calls:
        before = launches[kernel]
        got = wrapper(*args)
        torch.cuda.synchronize()
        check(launches[kernel] == before + 1, f"{kernel} did not launch")
        want = plain(*args)
        err = max(err, max_abs_err(got, want))
        check(same(got, want), f"{kernel} differs from its plain version")
    ms = time_ms(lambda: [wrapper(*a) for a in calls], reps)
    plain_ms = time_ms(lambda: [plain(*a) for a in calls], max(1, reps // 10))
    nbytes = sum(call_bytes(kernel, *a) for a in calls)
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
    calls = {name: [] for name in pu.LAUNCHES}
    for name, wire, args in made:
        calls[name].append((wire,) + args)
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


def log_rows(name: str, rows: dict, large_label: str, library: str) -> None:
    for label, r in (("main-path shapes", rows["main"]), (large_label, rows["large"])):
        log(f"[kernels] {name:20s} {label:22s} kernel {r['ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bytes']} B)  plain {r['plain_ms']:.4f} ms"
            + (f"  {library} {r['library_ms']:.4f} ms" if r["library_ms"] else "")
            + f"  max_abs_err {r['max_abs_err']}")


def phase_kernels(dev, main):
    """Phase 2: each DES kernel == plain at the main paths' calls and large."""
    rows = {}
    g = torch.Generator(device=dev).manual_seed(7)
    big = torch.randint(-2**31, 2**31, (1 << 26,), dtype=torch.int32, device=dev, generator=g)
    n_big = 4 * big.shape[0]
    large = {
        "unpack_run_aligned": [(big, 0, 4, 1 << 26, 4)],
        "unpack_run_general": [(big, 1, 13, (n_big - 1 - 13) // 13 + 1, 13)],
        "unpack_gather": [(big, torch.sort(torch.randint(
            0, n_big - 4, (1 << 24,), device=dev, generator=g)).values, 4)],
    }
    for name in pu.LAUNCHES:
        m = measure(name, main[name], reps=200)
        lg = measure(name, large[name], reps=20)
        m["library_ms"] = lg["library_ms"] = None
        if name == "unpack_run_aligned":
            m["library_ms"] = sum(strided_and_ms(a[0], a[1:], 200) for a in main[name])
            lg["library_ms"] = strided_and_ms(big, large[name][0][1:], 20)
        rows[name] = {"main": m, "large": lg}
        log_rows(name, rows[name], "large (256 MiB wire)", "strided view & mask")
    del big, large
    torch.cuda.empty_cache()
    return rows


def library_frame_ms(name: str, calls, reps: int) -> float:
    """The PyTorch calls that compute the same function: ``torch.cat`` of
    headers and payloads (pack), or the two slices made contiguous
    (unpack), checked equal to the kernel first."""
    if name == "pack_frames_batch":
        fn = lambda: [torch.cat([h, p], -1) for h, p in calls]  # noqa: E731
    else:
        fn = lambda: [(f[:, :4].contiguous(), f[:, 4:].contiguous())  # noqa: E731
                      for (f,) in calls]
    check(all(same(tuple(x) if isinstance(x, tuple) else x, KERNELS[name][3](*a))
              for x, a in zip(fn(), calls)), f"{name}: library call differs")
    return time_ms(fn, reps)


def phase_frame_kernels(dev, recorded):
    """Phase 8: each frame kernel == plain at the calls the sharded serve
    made (recorded) and at 2**20 frames of 4 + 64 words."""
    calls = {name: [] for name in FRAME_KERNELS}
    for name, args in recorded:
        calls[name].append(args)
    g = torch.Generator(device=dev).manual_seed(11)
    n, f = N_FRAMES_LARGE, 16
    large = {
        "pack_frames_batch": [(
            torch.randint(-2**31, 2**31, (n // f, f, 4), dtype=torch.int32, device=dev,
                          generator=g),
            torch.randint(-2**31, 2**31, (n // f, f, FRAME_WORDS), dtype=torch.int32,
                          device=dev, generator=g))],
        "unpack_frames_batch": [(torch.randint(
            -2**31, 2**31, (n, 4 + FRAME_WORDS), dtype=torch.int32, device=dev,
            generator=g),)],
    }
    rows = {}
    for name in FRAME_KERNELS:
        check(len(calls[name]) >= 1, f"{name}: no call recorded on the sharded path")
        m = measure(name, calls[name], reps=200)
        lg = measure(name, large[name], reps=20)
        m["library_ms"] = library_frame_ms(name, calls[name], 200)
        lg["library_ms"] = library_frame_ms(name, large[name], 20)
        m["calls"] = len(calls[name])
        rows[name] = {"main": m, "large": lg}
        shapes = sorted({tuple(tuple(t.shape) for t in a) for a in calls[name]})
        log(f"[kernels] {name}: {len(calls[name])} recorded calls, shapes {shapes}")
        log_rows(name, rows[name], "large (2**20 frames)",
                 "torch.cat" if name == "pack_frames_batch" else "slices .contiguous()")
    del large
    torch.cuda.empty_cache()
    return rows


def reset_launches() -> None:
    pu.reset_launches()
    fp.reset_launches()


def read_launches() -> dict:
    return {name: k[4][name] for name, k in KERNELS.items()}


def phase_serve(dev, wires):
    """Phase 3: the serving plane at full width; returns the path's
    launches, the yi-6b parameters, its config and the responses."""
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
    reset_launches()
    t0 = time.perf_counter()
    resp = serve.serve_requests(params, cfg, wires, max_new=MAX_NEW, pad_to=PAD_TO,
                                slots=SLOTS, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(launches["unpack_run_aligned"] >= 1, "serve run launched no unpack_run_aligned")
    check(launches["unpack_gather"] >= 1, "serve run launched no unpack_gather")
    n_out = check_responses(cfg, resp)
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
    del cache, state
    torch.cuda.empty_cache()
    return launches, params, cfg, resp


def check_responses(cfg, resp) -> int:
    """Every response parses back with its request id, N_PROMPTS outputs of
    MAX_NEW in-vocabulary tokens; returns the tokens generated."""
    n_out = 0
    for m, rw in enumerate(resp):
        rid, outs = serve.decode_response(rw)
        check(rid == m and len(outs) == N_PROMPTS, f"response {m}: bad header")
        for o in outs:
            check(len(o) == MAX_NEW and all(0 <= t < cfg.vocab for t in o),
                  f"response {m}: bad tokens")
            n_out += len(o)
    return n_out


def phase_records(plan, lanes, rec_wire, recs):
    """Phase 4: one large fixed-width record message through
    decode_message_kernel; returns its launches."""
    reset_launches()
    out = ops.decode_message_kernel(lanes, plan)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["unpack_run_general"] >= 1, "record path launched no unpack_run_general")
    want = np.zeros((len(recs), 16), np.uint8)
    want[:, :13] = recs
    check(np.array_equal(lanes_u32(out["recs.elem"]), want.view(np.uint32)),
          "record lanes differ from the record bytes")
    check(int(lanes_u32(out["hdr"])[0, 0]) == 0xABCDEF, "record header differs")
    log(f"[records] decode_message_kernel: {len(recs)} records of 13 bytes "
        f"({len(rec_wire)} B wire) decoded; launches {launches}")
    return launches


def fabric_run(fab, sends, idle: int):
    """Send, then tick ``idle`` + 1 times; every delivery as a tuple."""
    for s, d, w, lvl in sends:
        fab.send(s, d, w, lvl)
    got = []
    for _ in range(idle + 1):
        fab.exchange()
        for r in range(fab.n_ranks):
            got += [(r, x.src, x.wire, x.ok, x.list_level, x.arrive_step, x.attribution,
                     x.seq0) for x in fab.mailbox(r).recv()]
    return got, fab.counters_total()


def phase_fabric(dev):
    """Phase 5: seeded sends, ARQ under a seeded FaultPlan, through both
    tick engines on the card and the fused engine on the host."""
    rng = np.random.default_rng(SEED)
    sends = [(int(rng.integers(8)), int(rng.integers(8)),
              rng.integers(0, 256, int(rng.integers(1, 4000)), dtype=np.uint8).tobytes(),
              int(rng.integers(1, 4))) for _ in range(48)]
    plan = dict(seed=5, drop=0.03, corrupt=0.03, duplicate=0.03)
    out = {}
    reset_launches()
    for label, fused, where in (("fused", True, dev), ("programs", False, dev),
                                ("host fused", True, "cpu")):
        fab = Fabric(n_ranks=8, config=FabricConfig(arq=True, fused=fused), device=where)
        fab.faults = FaultPlan(**plan)
        t0 = time.perf_counter()
        out[label] = fabric_run(fab, sends, idle=40)
        dt = time.perf_counter() - t0
        log(f"[fabric] {label:10s} on {where}: {len(out[label][0])} messages, {fab.ticks} "
            f"ticks, {fab.router.scan_steps} scan steps, {dt * 1e3 / fab.ticks:.3f} ms/tick")
        if where == dev and fused:
            launches = read_launches()
    check(len(out["fused"][0]) == len(sends) and all(d[3] for d in out["fused"][0]),
          "fabric: ARQ did not deliver every message intact")
    for label in ("programs", "host fused"):
        check(out[label][0] == out["fused"][0], f"fabric: {label} deliveries differ")
        check(np.array_equal(out[label][1], out["fused"][1]), f"fabric: {label} counters differ")
    log("[fabric] fused == three-program on the card == fused on the host: deliveries, "
        "arrival steps, attribution and counters")
    return launches


def sharded_run(dev, params, cfg, wires, base, placement, label: str):
    """One sharded serve on a fresh default serve fabric, every response
    held to the batched plane's; returns its launches and the frame
    kernels' recorded calls."""
    fab = serve.default_serve_fabric(N_SHARDS, device=dev)
    tick_s = []
    exchange = fab.exchange

    def timed_exchange():
        t = time.perf_counter()
        exchange()  # ends in the host readback of the tick
        tick_s.append(time.perf_counter() - t)

    fab.exchange = timed_exchange
    placed = placement or serve.place_requests(
        fab.router, len(wires), list(range(1, fab.n_ranks)), capacity=SLOTS)
    log(f"[sharded] {label}: requests per shard "
        f"{ {s: placed.count(s) for s in range(1, fab.n_ranks)} }")
    reset_launches()
    t0 = time.perf_counter()
    with fp.recording() as made:
        resp = serve.serve_requests_sharded(params, cfg, wires, max_new=MAX_NEW,
                                            pad_to=PAD_TO, slots=SLOTS, fabric=fab,
                                            placement=placement, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    for name in FRAME_KERNELS:
        check(launches[name] >= 1, f"sharded serve launched no {name}")
    n_out = check_responses(cfg, resp)
    for m, (a, b) in enumerate(zip(resp, base)):
        check(a == b, f"sharded response {m} differs from the batched plane's")
    ticks = len(tick_s)
    log(f"[sharded] serve_requests_sharded: {len(wires)} requests over {N_SHARDS} shards, "
        f"{n_out} tokens in {dt:.3f} s: {len(wires) / dt:.3f} req/s, {n_out / dt:.1f} tok/s; "
        f"every response == the batched plane's; launches {launches}")
    log(f"[sharded] fabric: {ticks} ticks ({fab.exchanges} dispatched), "
        f"{fab.router.scan_steps} router scan steps ({fab.router.scan_steps / ticks:.2f} "
        f"per tick), {fab.frames_routed} frames; host ms per tick mean "
        f"{1e3 * sum(tick_s) / ticks:.3f} max {1e3 * max(tick_s):.3f}, fabric total "
        f"{1e3 * sum(tick_s):.3f} ms of {1e3 * dt:.3f} ms")
    return launches, made


def phase_sharded(dev, params, cfg, wires, base):
    """Phase 6: the sharded plane on the full-width model, twice: with the
    default placement (nearest shard with free capacity, which puts all 16
    requests on shard 1) and round-robin over the 3 shards, so that every
    shard decodes its own mix of sequences.  Returns each run's launches
    and the frame kernels' recorded calls of both."""
    runs = [sharded_run(dev, params, cfg, wires, base, None, "default placement"),
            sharded_run(dev, params, cfg, wires, base,
                        [1 + i % N_SHARDS for i in range(len(wires))], "round-robin")]
    return [r[0] for r in runs], [c for r in runs for c in r[1]]


def streaming_run(dev, params, cfg, wires, base, overlap: bool, logprobs: bool):
    """One streaming serve on a fresh default serve fabric; every check of
    phase 7.  Returns its launches and the B7 calls it made (recorded)."""
    fab = serve.default_serve_fabric(N_SHARDS, device=dev)
    host_s = {"exchange_async": [], "poll": []}
    for name in host_s:
        inner = getattr(fab, name)

        def timed(inner=inner, acc=host_s[name]):
            t = time.perf_counter()
            out = inner()
            acc.append(time.perf_counter() - t)
            return out

        setattr(fab, name, timed)  # exchange() calls both through these
    shards = list(range(1, fab.n_ranks))
    placed = serve.place_requests(fab.router, len(wires), shards, capacity=SLOTS,
                                  weights=[N_PROMPTS] * len(wires))
    label = f"overlap={overlap} logprobs={logprobs}"
    log(f"[stream] {label}: requests per shard "
        f"{ {s: placed.count(s) for s in shards} }")
    toks, first, lps = {}, {}, {}

    def on_token(m, j, step, tok):
        first.setdefault((m, j), time.perf_counter())
        check(step == len(toks.setdefault((m, j), [])), f"stream {(m, j)}: step out of order")
        toks[(m, j)].append(int(tok))

    def on_logprob(m, j, step, tok, lp):
        check(step == len(lps.setdefault((m, j), [])), f"logprobs {(m, j)}: step out of order")
        lps[(m, j)].append((int(tok), lp))

    reset_launches()
    t0 = time.perf_counter()
    with fp.recording() as made:
        resp = serve.serve_requests_streaming(
            params, cfg, wires, max_new=MAX_NEW, pad_to=PAD_TO, slots=SLOTS, fabric=fab,
            overlap=overlap, logprobs=logprobs, on_token=on_token,
            on_logprob=on_logprob if logprobs else None, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(launches["pack_chunks_batch"] >= 1, "streaming serve launched no pack_chunks_batch")
    n_out = check_responses(cfg, resp)
    for m, (a, b) in enumerate(zip(resp, base)):
        check(a == b, f"streamed response {m} differs from the batched plane's")
        for j, out in enumerate(serve.decode_response(b)[1]):
            check(toks.get((m, j)) == out, f"stream {(m, j)}: on_token tokens differ from "
                                           f"the batched plane's output")
    if logprobs:
        check(set(lps) == set(toks), "logprob streams != token streams")
        for key, pairs in lps.items():
            check([t for t, _ in pairs] == toks[key], f"logprob stream {key}: tokens differ")
            check(all(np.isfinite(v) and v <= 0.0 for _, v in pairs),
                  f"logprob stream {key}: a logprob is not finite or > 0")
    ttft = [first[k] - t0 for k in sorted(first)]
    tail = window_stats(ttft)  # the repo's ceil-rank p95
    ticks = fab.ticks
    fabric_s = sum(host_s["exchange_async"]) + sum(host_s["poll"])
    polls = host_s["poll"]
    result = {"s": dt, "req_s": len(wires) / dt, "tok_s": n_out / dt,
              "ttft_p50": statistics.median(ttft), "ttft_p95": tail["p95"],
              "ttft_max": tail["max"], "ticks": ticks,
              "fabric_ms_tick": 1e3 * fabric_s / ticks, "wall_ms_tick": 1e3 * dt / ticks,
              "poll_ms": 1e3 * sum(polls) / max(1, len(polls)), "polls": len(polls),
              "b7": launches["pack_chunks_batch"], "per_shard": {s: placed.count(s) for s in shards}}
    log(f"[stream] {label}: {len(wires)} requests, {n_out} tokens in {dt:.3f} s: "
        f"{result['req_s']:.3f} req/s, {result['tok_s']:.1f} tok/s; every wire == the "
        f"batched plane's, every stream == its sequence" + ("; logprobs == token stream, "
                                                            "finite, <= 0" if logprobs else ""))
    log(f"[stream] {label}: TTFT per stream (s from serve start, {len(ttft)} streams) p50 "
        f"{result['ttft_p50']:.3f} p95 {result['ttft_p95']:.3f} max {result['ttft_max']:.3f}")
    log(f"[stream] {label}: {ticks} fabric ticks, {fab.router.scan_steps} router scan steps, "
        f"{fab.frames_routed} frames; host ms per tick: fabric (exchange_async + poll) "
        f"{result['fabric_ms_tick']:.3f}, serve wall {result['wall_ms_tick']:.3f}; poll() "
        f"wait {result['poll_ms']:.3f} ms per call over {len(polls)} calls (max "
        f"{1e3 * max(polls, default=0.0):.3f}); B7 launches {result['b7']}; launches "
        f"{launches}")
    return launches, made, result


def phase_streaming(dev, params, cfg, wires, base):
    """Phase 7: the streaming plane, overlap and logprobs on, then both off.
    Returns each run's launches, the B7 calls of both, and their numbers."""
    runs = [streaming_run(dev, params, cfg, wires, base, overlap=True, logprobs=True),
            streaming_run(dev, params, cfg, wires, base, overlap=False, logprobs=False)]
    a, b = runs[0][2], runs[1][2]
    log(f"[stream] overlap on / off: wall {a['s']:.3f} / {b['s']:.3f} s; poll() wait per "
        f"tick {a['poll_ms']:.3f} / {b['poll_ms']:.3f} ms; fabric host ms per tick "
        f"{a['fabric_ms_tick']:.3f} / {b['fabric_ms_tick']:.3f}")
    calls = [args for r in runs for name, args in r[1] if name == "pack_chunks_batch"]
    return [r[0] for r in runs], calls


def library_chunks_ms(calls, reps: int) -> float:
    """``torch.where`` (masked form; the column index is an input) and
    ``torch.cat``: the PyTorch calls that compute the same rows, checked
    equal to the kernel first."""
    cols = {a[1].shape[1]: torch.arange(a[1].shape[1], device=a[1].device) for a in calls}

    def one(meta, toks, counts, ew):
        if ew:
            toks = torch.where(cols[toks.shape[1]] < counts * ew, toks, 0)
        return torch.cat([meta, toks, counts], -1)

    check(all(same(one(*a), fp.pack_chunks_batch(*a)) for a in calls),
          "pack_chunks_batch: library calls differ")
    return time_ms(lambda: [one(*a) for a in calls], reps)


def phase_chunk_kernel(dev, calls):
    """Phase 9: B7 == plain at the streaming serve's recorded calls and at
    the two large shapes (masked; the first also unmasked)."""
    check(len(calls) >= 1, "pack_chunks_batch: no call recorded on the streaming path")
    name = "pack_chunks_batch"
    m = measure(name, calls, reps=20)
    m["library_ms"] = library_chunks_ms(calls, 20)
    shapes = sorted({(tuple(a[1].shape), a[3]) for a in calls})
    log(f"[kernels] {name}: {len(calls)} recorded calls, (tokens shape, elem_words) {shapes}")
    g = torch.Generator(device=dev).manual_seed(13)
    large = []
    for n, cap, ew in CHUNK_LARGE:
        meta = torch.randint(-2**31, 2**31, (n, 3), dtype=torch.int32, device=dev, generator=g)
        toks = torch.randint(-2**31, 2**31, (n, cap * ew), dtype=torch.int32, device=dev,
                             generator=g)
        counts = torch.randint(0, cap + 1, (n, 1), dtype=torch.int32, device=dev, generator=g)
        large.append((f"{n} x cap {cap} x {ew} words, masked", [(meta, toks, counts, ew)]))
        if ew == 1:
            large.append((f"{n} x cap {cap}, unmasked", [(meta, toks, counts, 0)]))
    err = m["max_abs_err"]
    for label, lc in [("main-path shapes", None)] + large:
        r = m if lc is None else measure(name, lc, reps=20)
        if lc is not None:
            r["library_ms"] = library_chunks_ms(lc, 20)
        err = max(err, r["max_abs_err"])
        log(f"[kernels] {name:20s} {label:34s} kernel {r['ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bytes']} B)  plain {r['plain_ms']:.4f} ms  "
            f"where/cat {r['library_ms']:.4f} ms  max_abs_err {r['max_abs_err']}")
    rows = {"main": m, "large": {"max_abs_err": err}}
    del large
    torch.cuda.empty_cache()
    return {name: rows}


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
    serve_launches, params, cfg, base = phase_serve(dev, wires)
    path_launches = [serve_launches, phase_records(rec_plan, rec_lanes, rec_wire, recs),
                     phase_fabric(dev)]
    sharded_launches, recorded = phase_sharded(dev, params, cfg, wires, base)
    path_launches += sharded_launches
    streaming_launches, chunk_calls = phase_streaming(dev, params, cfg, wires, base)
    path_launches += streaming_launches
    del params
    torch.cuda.empty_cache()
    rows.update(phase_frame_kernels(dev, recorded))
    rows.update(phase_chunk_kernel(dev, chunk_calls))

    records = []
    for name, (source, replaces, _, _, _) in KERNELS.items():
        n = sum(p[name] for p in path_launches)
        check(n >= 1, f"{name} was not launched on any main path")
        m = rows[name]["main"]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
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
