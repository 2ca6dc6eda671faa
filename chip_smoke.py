#!/usr/bin/env python3
"""Chip smoke: drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

What it does, in order (any failed check raises and the exit code is 1):

1. Builds every CUDA source of the port with nvcc (``sm_90a``), all in
   parallel, and prints the card's name and power limit.
2. Kernels: each DES kernel (``unpack_run`` aligned and general,
   ``unpack_gather``) against its plain PyTorch version, bit for bit, at the
   calls the main paths make (recorded by the wrappers during one serve DES
   and one record decode) and at one large shape (a 256 MiB wire; B1 also
   at a strided one, 2**22 rows of 8 bytes at a pitch of 64).  Prints each
   kernel's time (CUDA events), its byte bound at the card's memory rate,
   its plain version's time and its library route's (B1: the strided word
   view & mask; B2: the byte-strided view, made contiguous, as int32, &
   mask; B3: the advanced-index byte gather, as int32, & mask; each checked
   equal to the kernel first), and what one wrapper call costs on the
   host, part by part (checks, allocation, stream handle, entry point,
   ctypes call; host clock, means over many calls).
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
   deliver the same bytes, arrival steps and counters; and the
   single-stream framer ``fabric.frames.frame_stream`` (structure pass,
   then the B5 join ``pack_frames_batch``) must frame the first sends on
   the card as on the host.
6. Sharded: ``serve_requests_sharded`` on the same yi-6b parameters and
   the same 16 wires, 3 shards, ARQ on, once with the default placement
   and once round-robin over the shards: every response must equal the
   batched plane's from phase 3, ``frame_batch`` must launch exactly once
   per dispatched fabric tick and ``unpack_frames_batch`` must launch.
   Prints req/s, tok/s, fabric ticks, router scan steps per tick and host
   ms per tick.
7. Streaming: ``serve_requests_streaming`` on the same parameters and
   wires, 3 shards, default placement (by sequence weight), ARQ on, once
   with ``overlap=True, logprobs=True`` and once with ``overlap=False,
   logprobs=False``: the final wires must equal the batched plane's, every
   stream's ``on_token`` tokens in step order that sequence's output, the
   logprob stream's tokens the token stream's, and every logprob must be
   finite and <= 0; every tick's lanes flush through
   ``stream.flush_lanes``, and each call of it that ships anything must
   be exactly one launch of B7's trimmed form (``chunk_bursts``; the
   drain included) while the padded form never launches; ``frame_batch``
   must launch once per dispatched fabric tick.  Prints req/s, tok/s,
   TTFT per stream (p50, p95, max), fabric ticks, host ms per tick, the
   ``poll()`` wait per tick, B7 launches per tick, the host ms per tick
   spent in lane flushes and requests per shard.
8. Frame kernels: ``frame_batch``, ``pack_frames_batch`` and
   ``unpack_frames_batch`` against their plain versions, bit for bit, at
   the calls phases 5-7 made (recorded by the wrappers: B5's join at
   phase 5's ``frame_stream`` calls, the only path that launches it;
   ``frame_batch`` and B6 at phase 6's, ``frame_batch`` also at phase
   7's) and at one large shape (2**20 frames of 68 words, 272 MiB), with
   their times, bounds and plain and library times.  B6 also in its word
   form at 2**20 frames of 4 + 63 words and at the 68-word frames viewed
   one word into their storage, each one launch == plain.  ``frame_batch``'s
   plain route is many calls (the structure pass, about a thousand eager
   ops, then ``torch.cat``); no one PyTorch call computes it.
9. Fragment kernels (run last, after phase 10): B7's two forms against
   their plain versions, bit for bit, with their times, bounds and plain
   and library times: the padded form ``pack_chunks_batch`` at the calls
   phase 10 made (recorded) and at two large shapes (2**20 fragments x cap
   64, one word each, and 2**19 x cap 32, two words each, seeded counts
   0..cap; masked, and the first unmasked too); the trimmed form
   ``chunk_bursts`` at the calls phase 7 made (recorded) and at 2**20 rows
   of 64 words' capacity with seeded elem_words 1 or 2 per row.
10. Device SER: the device-side SER entry points.  Phase 3's 16 request
   wires and its 16 answers (in their SW->HW layout, the one
   ``plan_from_wire`` reads; the served wires are HW->SW) are decoded on
   the card (``plan_from_wire``, ``decode_message_kernel``) and re-encoded
   with ``core.encode_message``, and every token run of them with
   ``kernels.ops.encode_run`` (B4); each must give back its wire byte for
   byte.  So must phase 4's 2**20-record wire.  ``encode_run`` at two
   256 MiB wires (2**24 rows of 13 bytes at a pitch of 16, so the lane
   mask bites, and of 8 bytes, so two words per row are zeros) must decode
   back (B1) to the masked tokens.  A host HW-to-HW framed stream (the
   records as a List, 500-phit frames of 16-byte phits) with its header
   words zeroed must come back from ``kernels.ops.write_headers`` (B8)
   byte for byte, and tables with a repeated and an overlapping word must
   stamp as the serial stamp does.  Every burst that phase 7's lanes
   shipped is packed again on the card by
   ``core.stream_plans.encode_fragment_burst`` (B7's padded form, one
   launch per burst) and must equal the host codec's bytes and the served
   burst.  Then B4 and B8 against their plain versions, bit for bit, at
   those calls (recorded) and at large shapes (B8: a 256 MiB wire and
   2**20 headers, ordered as a framer writes them and then shuffled, one
   launch per call), with their times, bounds and plain and library
   times.
11. Telemetry (after phase 7, on the same parameters and wires): the
   streaming serve (overlap and logprobs on) untraced, with ``metrics``,
   ``trace``, ``spans`` and ``analyze=True`` twice, and untraced again:
   the same wires (all == the batched plane's), the same kernel
   launches, ticks and ``exchange_async``/``poll`` calls; the trace and the metrics snapshot
   validate; every request span starts, has ``fabric.deliver`` and
   ``serve.first_token`` events and finishes, and its tick breakdown adds
   up to its ticks; ``evaluate_slo`` on a fixed spec gives a report;
   ``environment_meta()`` names the card.  Then
   ``serve_requests_sharded(analyze=True, trace=...)``: the batched
   plane's bytes and the untraced run's launches, one ``fabric.tick`` per
   fabric tick.  Then ``python -m repro_torch.analysis --strict`` (its
   JSON into a temporary directory) and ``python -m repro_torch.obs`` on
   the written snapshot (``--validate``, the report), trace, SLO and span
   export, all at once as subprocesses; each must exit 0.  Prints host ms
   per tick of each run, the host ms per tick spent inside the telemetry
   calls (trace, spans, ``analyze_sends``), trace events per tick and the
   trace's split of a streaming tick into ``fabric.tick`` and the rest,
   each beside the card's name and power limit.
12. Families (after every yi-6b phase): every other ``lm``
   architecture at full width, its depth cut to fit the card:
   phi3.5-moe-42b-a6.6b 16 of 32 layers (16 experts top-2 on every one),
   mixtral-8x22b 4 of 56 (8 experts top-2, window 4096), gemma2-27b 8 of
   46 (4 local + 4 global, softcaps, sandwich norms), jamba-1.5-large-398b
   5 of 72 (layers 0-3 Mamba-2, layer 4 attention, MoE on 1 and 3),
   xlstm-125m at its full 12, granite-34b 24 of 88 (multi-query attention:
   48 query heads on one K/V head, whose decode cache holds one head; the
   2-matrix gelu MLP) and stablelm-3b at its full 32 (full multi-head
   attention, 32 K/V heads).  For each: the float32 smoke model serves
   the same bytes on the card and the host; seeded bf16 weights from a
   generator on the card; ``serve_requests`` of 4 wires x 4 prompts of
   16-256 tokens (``pad_to=256``, ``max_new=16``, 16 slots), whose
   responses must parse back, whose B1/B3 counts must rise and whose
   recorded kernel calls must equal the plain versions; the prefill and
   decode step times; one extra prefill of the served batch, whose logits
   must be finite and whose ``aux`` gives the MoE models' ``moe_dropped``;
   then the weights are freed.  mixtral also serves one wire of 4 prompts
   of 4097-8192 tokens padded to 8192 on 4 slots (the window's ring, four
   MoE dispatch groups); xlstm also ``serve_requests_sharded`` over 3
   shards, round-robin, which must answer with the batched plane's bytes.
   Each line names the card and its power limit, with req/s, tok/s, the
   step times, the decode step's read bound (every weight and the whole
   slot cache read once at 3.35 TB/s) and the peak memory.
13. Multimodal families (after phase 12): phi-3-vision-4.2b (vlm; all 32
   layers, d 3072, a prefix of 576 vision tokens of width 1024, so each
   slot holds 272 + 576 K/V rows) and whisper-tiny (encdec; 4 encoder
   layers over 1500 frames, 4 decoder layers with cross attention, the
   encoder's K/V in every slot) at full width and depth in bf16, seeded
   weights from a generator on the card.  For each, phase 12's checks
   and load (smoke model card == host; 4 wires x 4 prompts, ``pad_to``
   256, ``max_new`` 16, 16 slots; responses parse; B1/B3 counts rise and
   their recorded calls == plain; prefill and decode step times and peak
   memory), fed the reference's zero ``vision``/``audio`` placeholders;
   then one extra prefill of the served batch with seeded non-zero
   ``vision``/``audio``, whose logits must be finite and differ from the
   placeholders'; then ``serve_requests_sharded`` (3 shards,
   round-robin) and, for whisper, ``serve_requests_streaming`` (overlap
   and logprobs), each equal to the batched plane's bytes, with
   ``frame_batch``, B6 and ``chunk_bursts`` counted and held to their
   plain versions at the recorded calls.  ``[mm]`` lines name the card
   and its power limit.  Phase 8 also re-times B6 against its two
   ``.contiguous()`` slices at 2**20 frames in alternating rounds, with its
   share of the byte bound.
14. Training (last, after phase 13): first the float32 smoke yi-6b takes
   4 train steps on the card and on the host from the same parameters and
   wires (losses and parameters must agree, TF32 off).  Then yi-6b at full
   width (d 4096, 32 heads, kv 4, d_ff 11008, vocab 64000, tied, bf16), 8
   of its 32 layers, seeded weights from a generator on the card:
   ``HGumBatchPipeline(seed=0)`` wires of 8 x 2048 tokens through a
   ``Prefetcher``, ``decode_batch`` on the card (exactly two B3
   ``unpack_gather`` launches a step, each recorded call == plain) and
   ``make_train_step`` (4 microbatches, remat "nothing") for 20 steps with
   fp32 moments under ``linear_warmup_cosine(3e-4, 10, 20)``, then 3 with
   q8 moments; every loss and grad norm must be finite; then 2 steps at a
   constant 1e-6 on the last batch, from fresh fp32 moments, must lower
   its loss.  Last, the train CLI's bitwise restart on the card
   (xlstm-125m smoke, 16 steps, ``--die-at 12`` and ``--resume auto``
   against the uninterrupted run, checkpoints equal bit for bit).
   ``[train]`` lines name the card and its power limit, with step ms (CUDA
   events), tokens/s, the ms inside ``decode_batch`` and ``adamw_update``,
   peak memory, and B3 at a step's two calls against its byte bound.
15. Multi-device drivers (last, after phase 14), on one card where a mesh
   axis is a tensor axis.  (a) The framed ring channel
   ``runtime.make_framed_sender`` over an 8-rank ring at
   ``benchmarks/bench_fabric.py``'s sizes (4096-byte payloads,
   ``frame_phits`` 16) and at 8 x 16 MiB: one B5 join launch a send,
   delivered payloads, nbytes and ``ok`` equal to the plain route on the
   host and (small size) to the ``Fabric``'s one-hop delivery, each
   recorded B5 call == plain.  (b) ``cross_pod_mean_int8`` at full width:
   the float32 grads of yi-6b's 8 layers for two 8 x 2048 batches as the
   two members of ``pod = 2``; per leaf the mean within one quantisation
   step of the float32 mean and the residual at most one step; the smoke
   model's result equal on card and host.  (c) ``gpipe_forward``: yi-6b's
   8 layers in 4 stages of 2, 8 microbatches of 1 x 2048 tokens, 11 ticks,
   bit for bit the stages applied to each microbatch in turn and within
   1 % (norm) of the whole-batch forward.  (d) ``launch.dryrun.lower_cell``
   on the (2, 2, 2) debug mesh for yi-6b at full width and 8 layers: two
   train steps, a prefill and four decode steps bit for bit the unsharded
   steps' from the same state.  (e) ``python -m repro_torch.launch.dryrun
   --arch yi-6b --mesh both`` (run beside (a)-(d)): every supported cell
   ``ok``, and the dry run's device-memory constant equal to what the
   card reports.  ``[multi]`` lines name the card and its power limit.
16. The README's examples (last, after phase 15).  First the MoE
   example's all-to-all (``examples/torch_moe_dispatch.py``'s ``route`` and
   ``expert_all_to_all``) at mixtral-8x22b's full width: one MoE layer
   (d 6144, 8 experts top-2, expert width 16384) in bf16 over 4 x 2048
   tokens, each token's experts as (rank, expert) token-id lists over an
   8-rank fabric, each list one routed framed List with the expert as its
   ListLevel; delivery bit-exact, every RX verdict ok, ``frame_batch``
   and B6 counted and each recorded call == plain.  Then the five example
   twins (``examples/torch_*.py``) as subprocesses with their reference
   defaults, side by side (the serve twin once more with ``--sharded
   --streaming --metrics-json --trace-out``), then ``torch_train_lm.py
   --full`` alone (demo-100m, 300 steps of 8 x 256; its loss must fall);
   each must exit 0 with its own assertions holding.  ``[examples]``
   lines name the card and its power limit, with each twin's wall
   seconds, the all-to-all's frames and exchange ms, and demo-100m's
   first and final loss and ms a step.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FrameWriter,
    Schema,
    SerFSM,
    build_rom,
    encode_message,
    lanes_u32,
    msg_to_des_tokens,
    plan_from_wire,
    ser_sw_to_hw,
    strip_for_ser,
)
from repro_torch.checkpoint import CheckpointManager, load_checkpoint  # noqa: E402
from repro_torch.core import fsm as host_fsm  # noqa: E402
from repro_torch.data import HGumBatchPipeline, Prefetcher  # noqa: E402
from repro_torch.data.pipeline import decode_batch  # noqa: E402
from repro_torch.data.schemas import request_schema, response_schema  # noqa: E402
from repro_torch.fabric import Fabric, FabricConfig, FaultPlan, frame_stream  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import frame_pack as fp  # noqa: E402
from repro_torch.kernels import phit_unpack as pu  # noqa: E402
from repro_torch.launch import costanalysis  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    cached_serve_steps,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.launch.train import deterministic  # noqa: E402
from repro_torch.models import init_params, loss_fn, param_count  # noqa: E402
from repro_torch.models import forward as model_forward  # noqa: E402
from repro_torch.models import prefill as model_prefill  # noqa: E402
from repro_torch.obs.metrics import window_stats  # noqa: E402
from repro_torch.models.model import layer_forward  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine  # noqa: E402
from repro_torch.optim import microbatched_grads  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    cross_pod_mean_int8,
    gpipe_forward,
    init_error,
    make_framed_sender,
    split_stages,
    stack_stage_params,
)
from repro_torch.runtime.sharding import leaf_paths, tree_map_with_path  # noqa: E402
from repro_torch.runtime.scheduler import extra_inputs  # noqa: E402
from repro_torch import stream as stream_pkg  # noqa: E402
from repro_torch.stream import plane as stream_plane  # noqa: E402

# the package's ``core`` exports a function named ``stream_plans`` too
stream_plans = importlib.import_module("repro_torch.core.stream_plans")

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
    "frame_batch": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:82",
                    fp.frame_batch_plain, fp.frame_batch, fp.LAUNCHES),
    "unpack_frames_batch": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:168",
                            fp.unpack_frames_batch_plain, fp.unpack_frames_batch,
                            fp.LAUNCHES),
    "pack_chunks_batch": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:118",
                          fp.pack_chunks_batch_plain, fp.pack_chunks_batch, fp.LAUNCHES),
    "chunk_bursts": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:118",
                     fp.chunk_bursts_plain, fp.chunk_bursts, fp.LAUNCHES),
    "pack_run": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:24",
                 fp.pack_run_plain, fp.pack_run, fp.LAUNCHES),
    "stamp_headers": (FRAME_SOURCE, "src/repro/kernels/frame_pack.py:68",
                      fp.stamp_headers_plain, fp.stamp_headers, fp.LAUNCHES),
}
FRAME_KERNELS = ("pack_frames_batch", "frame_batch", "unpack_frames_batch")
SER_KERNELS = ("pack_run", "stamp_headers")

# serve load (phase 3)
N_REQUESTS, N_PROMPTS, PROMPT_LENS = 16, 4, (16, 257)
PAD_TO, MAX_NEW, SLOTS, SEED = 256, 32, 16, 0
# record path (phase 4): hdr Bytes 3 + Array<Bytes 13>
RECORD_SCHEMA = {"Recs": [["hdr", ["Bytes", 3]], ["recs", ["Array", ["Bytes", 13]]]]}
N_RECORDS = 1 << 20
# B1's strided large shape (phase 2): (rows, nbytes, pitch) in the 256 MiB wire
STRIDED_LARGE = (1 << 22, 8, 64)
# wrapper-cost breakdown (phase 2): host calls per part
COST_REPS = 2000
# sharded plane (phase 6) and the frame kernels' large shape (phase 8):
# frame_batch frames 2**16 streams of 15 frames' payload (+ terminator)
N_SHARDS = 3
N_FRAMES_LARGE, FRAME_WORDS = 1 << 20, 64
FRAME_STREAMS_LARGE = 1 << 16
# the fragment kernel's large shapes (phase 9): (fragments, cap, elem_words);
# the trimmed form's: rows, element words of capacity (elem_words 1 or 2)
CHUNK_LARGE = ((1 << 20, 64, 1), (1 << 19, 32, 2))
BURST_LARGE = (1 << 20, 64)
# device SER (phase 10): encode_run's 256 MiB wires as (rows, nbytes, stride);
# the framed stream carries phase 4's records as a List (hw2hw frames only
# carry List data); B8's large shape: a 256 MiB wire and 2**20 headers
PACK_LARGE = ((1 << 24, 13, 16), (1 << 24, 8, 16))
RECORD_LIST_SCHEMA = {"Recs": [["hdr", ["Bytes", 3]], ["recs", ["List", ["Bytes", 13]]]]}
STAMP_LARGE_WORDS, STAMP_LARGE_HEADERS = 1 << 26, 1 << 20
# telemetry (phase 11): the fixed SLO the traced streaming serve is held to
SLO_SPEC = "ttft_p95_s=60,tokens_per_s_min=1,arrive_p95_steps=64,drift_free"
# model families (phase 12): each architecture at full width, its depth cut
# to fit one card (layers run); 4 wires of phase 3's prompts, MAX_NEW 16
# (granite-34b: multi-query attention, 0.76 GB of bf16 weights a layer, so
# 24 of 88 layers are about 18 GB; stablelm-3b: full multi-head attention,
# all 32 layers)
FAMILY_LAYERS = {"phi3.5-moe-42b-a6.6b": 16, "mixtral-8x22b": 4, "gemma2-27b": 8,
                 "jamba-1.5-large-398b": 5, "xlstm-125m": 12, "granite-34b": 24,
                 "stablelm-3b": 32}
FAMILY_REQUESTS, FAMILY_MAX_NEW = 4, 16
# mixtral's long serve: one wire of 4 prompts of 4097-8192 tokens, padded to
# 8192 (the window, 4096, divides it): its ring and four MoE dispatch groups
LONG_PROMPT_LENS, LONG_PAD_TO, LONG_SLOTS = (4097, 8193), 8192, 4
# the vlm and encdec families (phase 13): full width and full depth, phase
# 12's load; the sharded plane for both, the streaming plane for whisper
MULTIMODAL_ARCHS = ("phi-3-vision-4.2b", "whisper-tiny")
MULTIMODAL_STREAMING = ("whisper-tiny",)
# B6 against its two .contiguous() slices at 2**20 frames (phase 8):
# alternating rounds of this many calls each
B6_ROUNDS, B6_ROUND_REPS = 21, 50
# training (phase 14): yi-6b at full width, 8 of its 32 layers (its float32
# master, moments and accumulator take about 20 B a parameter), batches of
# 8 x 2048 tokens in its own 4 microbatches, 20 steps with fp32 moments
# under a warmup-cosine schedule, then 3 with q8 moments at the schedule's
# floor; the float32 smoke model's card == host run; the CLI's restart
TRAIN_ARCH, TRAIN_LAYERS = "yi-6b", 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_Q8_STEPS = 8, 2048, 20, 3
TRAIN_LR, TRAIN_WARMUP = 3e-4, 10
SMOKE_TRAIN = dict(steps=4, batch=4, seq=64, lr=1e-3, warmup=1)
# descent on one batch (after the run): fresh fp32 moments, a constant rate
# small enough for the first steps of a 1.6 B model from scratch
DESCENT_LR, DESCENT_STEPS = 1e-6, 2
RESTART_ARGS = ["--arch", "xlstm-125m", "--smoke", "--steps", "16", "--batch", "2",
                "--seq", "32", "--ckpt-every", "4"]
# multi-device drivers (phase 15): the framed ring channel at
# benchmarks/bench_fabric.py's sizes (8 ranks, 4096-byte payloads, 16-phit
# frames) and at 8 x 16 MiB; GPipe over yi-6b's 8 layers in 4 stages of 2,
# 8 microbatches of 1 x 2048 tokens; the sharded steps on the (2, 2, 2)
# debug mesh; the dry run of yi-6b on both production meshes
RING_RANKS, RING_BYTES, RING_PHITS, RING_LARGE_BYTES = 8, 4096, 16, 16 << 20
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 2048
SHARD_MESH = ((2, 2, 2), ("pod", "data", "model"))
SHARD_DECODE_STEPS = 4
#: norm-wise bound of the pipelined forward against the whole-batch one:
#: bf16 activations through 8 layers whose GEMMs tile another M
PIPE_WHOLE_RTOL = 1e-2
# the README's examples (phase 16): the twins as subprocesses with their
# reference defaults (label, script, arguments), side by side; the serve
# twin also with every plane and both telemetry files; then the ~100M
# train_lm --full alone.  The MoE all-to-all at mixtral-8x22b's full width:
# one MoE layer over 4 x 2048 tokens, the expert lists over 8 ranks
EXAMPLE_RUNS = (
    ("quickstart", "torch_quickstart.py", []),
    ("serve_requests", "torch_serve_requests.py", []),
    ("serve_requests --sharded --streaming", "torch_serve_requests.py",
     ["--sharded", "--streaming", "--metrics-json", "m.json", "--trace-out", "t.json"]),
    ("typed_streams", "torch_typed_streams.py", []),
    ("moe_dispatch", "torch_moe_dispatch.py", []),
    ("train_lm", "torch_train_lm.py", []),
)
FULL_TRAIN_STEPS = 300
FULL_TRAIN = ("train_lm --full", "torch_train_lm.py",
              ["--full", "--steps", str(FULL_TRAIN_STEPS)])
EXAMPLE_TIMEOUT_S = 600
MOE_ARCH, MOE_TOKENS = "mixtral-8x22b", (4, 2048)


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
    every output word written once, i.e. twice the inputs' bytes;
    ``frame_batch``: the live payload words (below each stream's byte
    count) and the per-stream counts, routes and levels read, the frames
    written.  B4: the
    token bytes below ``nbytes`` read, the wire written; B8: the wire read
    and written, the header table read."""
    if kernel == "frame_batch":
        nb, rt, lv, phits, _ = args
        B, row_words = wire.shape
        live = int(((nb + 3) // 4).clamp(0, row_words).sum())
        frames = B * (-(-row_words // (4 * phits)) + 1) * (4 + 4 * phits)
        return 4 * live + 8 * (nb.numel() + rt.numel() + lv.numel()) + 4 * frames
    if kernel in FRAME_KERNELS:
        return 2 * 4 * sum(t.numel() for t in (wire,) + args)
    if kernel == "pack_run":
        # the token bytes read (lane-masked bytes are not needed), the wire written
        stride, nbytes = args
        return wire.shape[0] * (nbytes + stride)
    if kernel == "stamp_headers":
        # the wire read and written once, the header table read once
        (headers,) = args
        return 2 * 4 * wire.numel() + 4 * headers.numel()
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
    if kernel == "chunk_bursts":
        # meta, counts, elem_words and offsets read, the live element words
        # read, the trimmed rows written
        tokens, counts, elem_words, offsets, n_words = args
        rows = counts.shape[0]
        live = n_words - rows * 4
        return 4 * (wire.numel() + counts.numel() + elem_words.numel() + live + n_words) \
            + 8 * offsets.numel()
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


def lane_mask_i32(nbytes: int, dev) -> torch.Tensor:
    """The (nlanes,) int32 masks that zero a token's bytes past ``nbytes``."""
    nlanes = (nbytes + 3) // 4
    return torch.tensor([(1 << 8 * (nbytes - 4 * j)) - 1 if nbytes - 4 * j < 4 else -1
                         for j in range(nlanes)], dtype=torch.int32, device=dev)


def wire_bytes(wire: torch.Tensor, end: int) -> torch.Tensor:
    """The wire's bytes as uint8, zero-padded to at least ``end`` bytes
    (a read past the wire reads zeros, as in the kernels)."""
    u8 = wire.view(torch.uint8)
    if end > u8.numel():
        u8 = torch.cat([u8, u8.new_zeros(end - u8.numel())])
    return u8


def byte_view_ms(wire: torch.Tensor, args: tuple, reps: int) -> float:
    """PyTorch calls computing a run at any byte base and stride (B2): the
    byte-strided view of the wire, copied into contiguous rows (a fresh
    copy: a view at an unaligned byte offset cannot be viewed as int32),
    viewed as int32 and ANDed with the lane mask (the padded byte view and
    the mask are inputs)."""
    base, stride, count, nbytes = args
    mask = lane_mask_i32(nbytes, wire.device)
    width = 4 * mask.shape[0]
    u8 = wire_bytes(wire, base + stride * max(count - 1, 0) + width)

    def run():
        rows = torch.as_strided(u8, (count, width), (stride, 1), base)
        return torch.bitwise_and(
            rows.clone(memory_format=torch.contiguous_format).view(torch.int32), mask)

    check(torch.equal(run(), pu.unpack_run_general(wire, *args)),
          "byte view & mask differs from unpack_run_general")
    return time_ms(run, reps)


def byte_gather_ms(wire: torch.Tensor, args: tuple, reps: int) -> float:
    """PyTorch calls computing one row per byte offset (B3): the advanced
    index ``wire_u8[offsets[:, None] + arange(4 * nlanes)]``, viewed as
    int32 and ANDed with the lane mask (the padded byte view, the column
    index and the mask are inputs)."""
    offsets, nbytes = args
    mask = lane_mask_i32(nbytes, wire.device)
    cols = torch.arange(4 * mask.shape[0], device=wire.device)
    end = int(offsets.max()) + cols.numel() if offsets.numel() else 0
    u8 = wire_bytes(wire, end)

    def run():
        return torch.bitwise_and(u8[offsets[:, None] + cols].view(torch.int32), mask)

    check(torch.equal(run(), pu.unpack_gather(wire, *args)),
          "byte gather & mask differs from unpack_gather")
    return time_ms(run, reps)


def strided_and_ms(wire: torch.Tensor, args: tuple, reps: int) -> float:
    """One PyTorch call computing an aligned run: the strided view of the
    rows' words ANDed with the lane mask (the view and mask are inputs)."""
    base, stride, count, nbytes = args
    mask = lane_mask_i32(nbytes, wire.device)
    view = torch.as_strided(wire, (count, mask.shape[0]), (stride // 4, 1), base // 4)
    check(torch.equal(torch.bitwise_and(view, mask), pu.unpack_run_aligned(wire, *args)),
          "strided view & mask differs from unpack_run_aligned")
    return time_ms(lambda: torch.bitwise_and(view, mask), reps)


#: DES kernel -> (its one-call library route, the route's name)
DES_LIBRARY = {
    "unpack_run_aligned": (strided_and_ms, "strided view & mask"),
    "unpack_run_general": (byte_view_ms, "byte view & mask"),
    "unpack_gather": (byte_gather_ms, "byte gather & mask"),
}


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
    """Phase 2: each DES kernel == plain at the main paths' calls and large
    (B1 at a dense and at a strided large shape)."""
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
    n_rows, nb, pitch = STRIDED_LARGE
    strided = [(big, 0, pitch, n_rows, nb)]
    for name in pu.LAUNCHES:
        m = measure(name, main[name], reps=200)
        lg = measure(name, large[name], reps=20)
        library, route = DES_LIBRARY[name]
        m["library_ms"] = sum(library(a[0], a[1:], 200) for a in main[name])
        lg["library_ms"] = library(big, large[name][0][1:], 20)
        torch.cuda.empty_cache()
        rows[name] = {"main": m, "large": lg}
        log_rows(name, rows[name], "large (256 MiB wire)", route)
        if name == "unpack_run_aligned":
            st = measure(name, strided, reps=20)
            st["library_ms"] = strided_and_ms(big, strided[0][1:], 20)
            lg["max_abs_err"] = max(lg["max_abs_err"], st["max_abs_err"])
            log(f"[kernels] {name:20s} {f'{n_rows} rows x {nb} B at {pitch}':22s} kernel "
                f"{st['ms']:.4f} ms  bound {st['bound_ms']:.4f} ms ({st['bytes']} B)  plain "
                f"{st['plain_ms']:.4f} ms  strided view & mask {st['library_ms']:.4f} ms  "
                f"max_abs_err {st['max_abs_err']}")
    wrapper_costs(main["unpack_run_aligned"][0])
    del big, large, strided
    torch.cuda.empty_cache()
    return rows


def host_us(fn, reps: int = COST_REPS) -> float:
    """Mean host microseconds of ``fn()`` over ``reps`` calls (the work
    they queue on the card is drained after the clock stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    dt = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return dt / reps / 1e3


def wrapper_costs(call) -> None:
    """One ``unpack_run_aligned`` wrapper call at a main-path call (the
    serve's req_id run), taken apart on the host clock: the checks, the
    output allocation, the stream handle (the raw handle the wrappers read
    now, and the ``torch.cuda.Stream`` object they built before), the
    entry point's lookup, the ctypes call that launches, the whole wrapper,
    and the strided view & mask that computes the same function."""
    wire, base, stride, count, nbytes = call
    nlanes = (nbytes + 3) // 4
    out = torch.empty((count, nlanes), dtype=torch.int32, device=wire.device)
    lib = pu._library()
    fn = lib.hgum_unpack_run_aligned
    args = (wire.data_ptr(), wire.shape[0], out.data_ptr(), base // 4, stride // 4, count,
            nlanes, nbytes, pu._stream(wire))
    mask = lane_mask_i32(nbytes, wire.device)
    view = torch.as_strided(wire, (count, nlanes), (stride // 4, 1), base // 4)

    def checks():
        pu._check_aligned(base, stride)
        pu._on_cpu(wire, nbytes, count)

    parts = {
        "checks": checks,
        "torch.empty": lambda: torch.empty((count, nlanes), dtype=torch.int32,
                                           device=wire.device),
        "stream (raw handle)": lambda: pu._stream(wire),
        "stream (torch.cuda.current_stream().cuda_stream)":
            lambda: torch.cuda.current_stream(wire.device).cuda_stream,
        "entry point (getattr on the typed CDLL)": lambda: getattr(pu._library(),
                                                                   "hgum_unpack_run_aligned"),
        "ctypes call (launch)": lambda: fn(*args),
        "whole wrapper": lambda: pu.unpack_run_aligned(wire, base, stride, count, nbytes),
        "library: strided view & mask": lambda: torch.bitwise_and(view, mask),
    }
    costs = {k: host_us(f) for k, f in parts.items()}
    log(f"[cost] unpack_run_aligned wrapper at the serve's call ({count} rows x {nbytes} B "
        f"at {stride}), host us per call over {COST_REPS} calls: "
        + "; ".join(f"{k} {v:.3f}" for k, v in costs.items()))


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


def b6_against_slices(frames: torch.Tensor) -> None:
    """B6 and the two ``.contiguous()`` slices at 2**20 frames, in
    ``B6_ROUNDS`` alternating rounds (kernel first in even rounds, slices
    first in odd ones) of ``B6_ROUND_REPS`` calls each: the per-round
    medians and spreads, and the median of the per-round ratios."""
    kernel = lambda: fp.unpack_frames_batch(frames)  # noqa: E731
    slices = lambda: (frames[:, :4].contiguous(), frames[:, 4:].contiguous())  # noqa: E731
    ks, ls = [], []
    for r in range(B6_ROUNDS):
        pair = [(kernel, ks), (slices, ls)]
        for fn, acc in pair if r % 2 == 0 else pair[::-1]:
            acc.append(time_ms(fn, B6_ROUND_REPS, warmup=3))
    ratios = sorted(k / lib for k, lib in zip(ks, ls))
    med = statistics.median
    bound_ms = call_bytes("unpack_frames_batch", frames) / HBM_BYTES_PER_S * 1e3
    log(f"[kernels] B6 vs slices at 2**20 frames, {B6_ROUNDS} alternating rounds of "
        f"{B6_ROUND_REPS} calls: kernel median {med(ks):.4f} ms (min {min(ks):.4f}, max "
        f"{max(ks):.4f}), {100 * bound_ms / med(ks):.1f} % of its bound {bound_ms:.4f} ms; "
        f"slices median {med(ls):.4f} ms (min {min(ls):.4f}, max "
        f"{max(ls):.4f}); kernel / slices per round: median {med(ratios):.4f}, min "
        f"{ratios[0]:.4f}, max {ratios[-1]:.4f}; kernel slower in "
        f"{sum(x > 1 for x in ratios)} of {B6_ROUNDS} rounds")


def b6_word_form(dev, g) -> int:
    """B6's word form at 2**20 frames: payloads of 63 words (not whole
    phits), and frames of 68 words viewed one word into their storage (not
    16-byte aligned).  Each == plain bit for bit in one launch; prints the
    kernel's, plain and slices' times and the bound; returns the largest
    max_abs_err."""
    n = N_FRAMES_LARGE
    buf = torch.randint(-2**31, 2**31, (1 + n * (4 + FRAME_WORDS),), dtype=torch.int32,
                        device=dev, generator=g)
    shapes = {f"2**20 x (4 + {FRAME_WORDS - 1})":
              buf[:n * (3 + FRAME_WORDS)].view(n, 3 + FRAME_WORDS),
              f"2**20 x (4 + {FRAME_WORDS}) +1 word": buf[1:].view(n, 4 + FRAME_WORDS)}
    err = 0
    for label, frames in shapes.items():
        calls = [(frames,)]
        r = measure("unpack_frames_batch", calls, reps=20)
        lib = library_frame_ms("unpack_frames_batch", calls, 20)
        err = max(err, r["max_abs_err"])
        log(f"[kernels] {'unpack_frames_batch':20s} {label + ' (words)':22s} kernel "
            f"{r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bytes']} B, "
            f"{100 * r['bound_ms'] / r['ms']:.1f} %)  plain {r['plain_ms']:.4f} ms  slices "
            f".contiguous() {lib:.4f} ms  max_abs_err {r['max_abs_err']}")
    return err


def phase_frame_kernels(dev, recorded, stream_framing, joins):
    """Phase 8: each frame kernel == plain at the calls phases 5-7 made
    (recorded) and at 2**20 frames of 4 + 64 words."""
    calls = {name: [] for name in FRAME_KERNELS}
    for name, args in recorded:
        calls[name].append(args)
    calls["pack_frames_batch"] = joins
    where = {"pack_frames_batch": "phase 5's frame_stream"}
    g = torch.Generator(device=dev).manual_seed(11)
    n, f = N_FRAMES_LARGE, 16
    streams, row_words = FRAME_STREAMS_LARGE, (N_FRAMES_LARGE // FRAME_STREAMS_LARGE - 1) * 64
    large = {
        "pack_frames_batch": [(
            torch.randint(-2**31, 2**31, (n // f, f, 4), dtype=torch.int32, device=dev,
                          generator=g),
            torch.randint(-2**31, 2**31, (n // f, f, FRAME_WORDS), dtype=torch.int32,
                          device=dev, generator=g))],
        # full streams but for a seeded part of the last frame
        "frame_batch": [(
            torch.randint(-2**31, 2**31, (streams, row_words), dtype=torch.int32,
                          device=dev, generator=g),
            4 * row_words - torch.randint(0, 4 * FRAME_WORDS, (streams,), device=dev,
                                          generator=g),
            torch.randint(0, 2**16, (streams, 3), device=dev, generator=g),
            torch.randint(0, 256, (streams,), device=dev, generator=g),
            FRAME_WORDS // 4, True)],
        "unpack_frames_batch": [(torch.randint(
            -2**31, 2**31, (n, 4 + FRAME_WORDS), dtype=torch.int32, device=dev,
            generator=g),)],
    }
    rows = {}
    for name in FRAME_KERNELS:
        path = where.get(name, "the sharded path")
        check(len(calls[name]) >= 1, f"{name}: no call recorded on {path}")
        m = measure(name, calls[name], reps=200)
        lg = measure(name, large[name], reps=20)
        if name == "frame_batch":
            m["library_ms"] = lg["library_ms"] = None
        else:
            m["library_ms"] = library_frame_ms(name, calls[name], 200)
            lg["library_ms"] = library_frame_ms(name, large[name], 20)
        m["calls"] = len(calls[name])
        rows[name] = {"main": m, "large": lg}
        shapes = sorted({tuple(tuple(t.shape) for t in a if isinstance(t, torch.Tensor))
                         for a in calls[name]})
        log(f"[kernels] {name}: {len(calls[name])} calls of {path}, shapes {shapes}")
        log_rows(name, rows[name], "large (2**20 frames)",
                 {"pack_frames_batch": "torch.cat",
                  "unpack_frames_batch": "slices .contiguous()"}.get(name, ""))
    b6_against_slices(large["unpack_frames_batch"][0][0])
    rows["unpack_frames_batch"]["large"]["max_abs_err"] = max(
        rows["unpack_frames_batch"]["large"]["max_abs_err"], b6_word_form(dev, g))
    # frame_batch at the streaming serves' calls
    check(len(stream_framing) >= 1, "frame_batch: no streaming calls recorded")
    r = measure("frame_batch", stream_framing, 20)
    rows["frame_batch"]["large"]["max_abs_err"] = max(
        rows["frame_batch"]["large"]["max_abs_err"], r["max_abs_err"])
    log(f"[kernels] {'frame_batch':20s} {f'{len(stream_framing)} streaming calls':22s} kernel "
        f"{r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bytes']} B)  plain "
        f"{r['plain_ms']:.4f} ms  max_abs_err {r['max_abs_err']}")
    log("[kernels] frame_batch's plain route is the structure pass (its CRC a loop over the "
        "words of a frame, about a thousand eager ops a call) and torch.cat: many calls")
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


def check_responses(cfg, resp, max_new: int = MAX_NEW) -> int:
    """Every response parses back with its request id, N_PROMPTS outputs of
    ``max_new`` in-vocabulary tokens; returns the tokens generated."""
    n_out = 0
    for m, rw in enumerate(resp):
        rid, outs = serve.decode_response(rw)
        check(rid == m and len(outs) == N_PROMPTS, f"response {m}: bad header")
        for o in outs:
            check(len(o) == max_new and all(0 <= t < cfg.vocab for t in o),
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
    tick engines on the card and the fused engine on the host; and the
    single-stream framer on the card and on the host.  Returns the card's
    launches (framer and fused engine) and the framer's recorded calls."""
    rng = np.random.default_rng(SEED)
    sends = [(int(rng.integers(8)), int(rng.integers(8)),
              rng.integers(0, 256, int(rng.integers(1, 4000)), dtype=np.uint8).tobytes(),
              int(rng.integers(1, 4))) for _ in range(48)]
    plan = dict(seed=5, drop=0.03, corrupt=0.03, duplicate=0.03)
    out = {}
    reset_launches()
    with fp.recording() as made:
        for i, (src, dst, wire, lvl) in enumerate(sends[:8]):
            lanes = ops.wire_to_u32(wire, dev)
            kw = dict(list_level=lvl, frame_phits=16, route=(src, dst, 65530 + i),
                      adaptive=bool(i % 2))
            f_card, n_card = frame_stream(lanes, len(wire), **kw)
            f_host, n_host = frame_stream(lanes.cpu(), len(wire), **kw)
            check(torch.equal(f_card.cpu(), f_host) and int(n_card) == int(n_host),
                  "frame_stream: card and host frames differ")
    check(fp.LAUNCHES["pack_frames_batch"] == 8, "frame_stream did not launch B5 once a call")
    log("[fabric] frame_stream on the card == on the host for 8 sends (B5 join, 8 launches)")
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
            check(launches["frame_batch"] == fab.exchanges,
                  "fused fabric: frame_batch launches != dispatched ticks")
    check(len(out["fused"][0]) == len(sends) and all(d[3] for d in out["fused"][0]),
          "fabric: ARQ did not deliver every message intact")
    for label in ("programs", "host fused"):
        check(out[label][0] == out["fused"][0], f"fabric: {label} deliveries differ")
        check(np.array_equal(out[label][1], out["fused"][1]), f"fabric: {label} counters differ")
    log("[fabric] fused == three-program on the card == fused on the host: deliveries, "
        "arrival steps, attribution and counters")
    return launches, [a for k, a in made if k == "pack_frames_batch"]


def sharded_run(dev, params, cfg, wires, base, placement, label: str, telemetry=None,
                max_new: int = MAX_NEW):
    """One sharded serve on a fresh default serve fabric, every response
    held to the batched plane's; ``telemetry`` (keyword arguments such as
    ``trace``, ``analyze``) goes to the serve.  Returns its launches, the
    frame kernels' recorded calls and the fabric."""
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
        resp = serve.serve_requests_sharded(params, cfg, wires, max_new=max_new,
                                            pad_to=PAD_TO, slots=SLOTS, fabric=fab,
                                            placement=placement, device=dev,
                                            **(telemetry or {}))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(launches["unpack_frames_batch"] >= 1, "sharded serve launched no unpack_frames_batch")
    check(launches["frame_batch"] == fab.exchanges >= 1,
          f"sharded serve: {launches['frame_batch']} frame_batch launches for "
          f"{fab.exchanges} dispatched ticks")
    check(launches["pack_frames_batch"] == 0, "sharded serve framed through the join")
    n_out = check_responses(cfg, resp, max_new)
    for m, (a, b) in enumerate(zip(resp, base)):
        check(a == b, f"sharded response {m} differs from the batched plane's")
    ticks = len(tick_s)
    log(f"[sharded] serve_requests_sharded: {len(wires)} requests over {N_SHARDS} shards, "
        f"{n_out} tokens in {dt:.3f} s: {len(wires) / dt:.3f} req/s, {n_out / dt:.1f} tok/s; "
        f"every response == the batched plane's; launches {launches}")
    log(f"[sharded] fabric: {ticks} ticks ({fab.exchanges} dispatched), "
        f"{fab.router.scan_steps} router scan steps ({fab.router.scan_steps / ticks:.2f} "
        f"per tick), {fab.frames_routed} frames, one frame_batch launch per dispatched "
        f"tick; host ms per tick mean "
        f"{1e3 * sum(tick_s) / ticks:.3f} max {1e3 * max(tick_s):.3f}, fabric total "
        f"{1e3 * sum(tick_s):.3f} ms of {1e3 * dt:.3f} ms")
    return launches, made, fab


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


def streaming_run(dev, params, cfg, wires, base, overlap: bool, logprobs: bool,
                  telemetry=None, max_new: int = MAX_NEW):
    """One streaming serve on a fresh default serve fabric; every check of
    phase 7.  ``telemetry`` (keyword arguments such as ``trace``,
    ``spans``, ``metrics``, ``analyze``) goes to the serve.  Returns its
    launches, the kernel calls it made (recorded), its numbers, and every
    (plan, chunks) -> burst its lanes shipped."""
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
    label = f"overlap={overlap} logprobs={logprobs}" + (" traced" if telemetry else "")
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

    # lane flushes: host time and chunks shipped per call; the bursts packed
    flush_s, shipped, bursts = [], [], []
    flush_lanes, encode_bursts = stream_pkg.flush_lanes, stream_plane.encode_fragment_bursts

    def timed_flush(lanes, force=False):
        t = time.perf_counter()
        n = flush_lanes(lanes, force)
        flush_s.append(time.perf_counter() - t)
        shipped.append(n)
        return n

    def noted_bursts(items, device=None):
        out = encode_bursts(items, device)
        bursts.extend((plan, list(chunks), b) for (plan, chunks), b in zip(items, out))
        return out

    reset_launches()
    t0 = time.perf_counter()
    with fp.recording() as made, \
            mock.patch.object(stream_pkg, "flush_lanes", timed_flush), \
            mock.patch.object(stream_plane, "encode_fragment_bursts", noted_bursts):
        resp = serve.serve_requests_streaming(
            params, cfg, wires, max_new=max_new, pad_to=PAD_TO, slots=SLOTS, fabric=fab,
            overlap=overlap, logprobs=logprobs, on_token=on_token,
            on_logprob=on_logprob if logprobs else None, device=dev, **(telemetry or {}))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    shipping = sum(1 for n in shipped if n)
    check(launches["chunk_bursts"] == shipping >= 1,
          f"streaming serve: {launches['chunk_bursts']} chunk_bursts launches for "
          f"{shipping} lane flushes that shipped")
    check(launches["pack_chunks_batch"] == 0, "streaming serve packed through the padded form")
    check(launches["frame_batch"] == fab.exchanges >= 1,
          f"streaming serve: {launches['frame_batch']} frame_batch launches for "
          f"{fab.exchanges} dispatched ticks")
    n_out = check_responses(cfg, resp, max_new)
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
              "exchange_ms_tick": 1e3 * sum(host_s["exchange_async"]) / ticks,
              "fabric_ms_tick": 1e3 * fabric_s / ticks, "wall_ms_tick": 1e3 * dt / ticks,
              "poll_ms": 1e3 * sum(polls) / max(1, len(polls)), "polls": len(polls),
              "b7": launches["chunk_bursts"], "b7_tick": launches["chunk_bursts"] / ticks,
              "flush_ms_tick": 1e3 * sum(flush_s) / ticks, "flushes": len(flush_s),
              "per_shard": {s: placed.count(s) for s in shards},
              "exchanges": fab.exchanges, "polls_n": len(polls),
              "exchange_async_n": len(host_s["exchange_async"])}
    log(f"[stream] {label}: {len(wires)} requests, {n_out} tokens in {dt:.3f} s: "
        f"{result['req_s']:.3f} req/s, {result['tok_s']:.1f} tok/s; every wire == the "
        f"batched plane's, every stream == its sequence" + ("; logprobs == token stream, "
                                                            "finite, <= 0" if logprobs else ""))
    log(f"[stream] {label}: TTFT per stream (s from serve start, {len(ttft)} streams) p50 "
        f"{result['ttft_p50']:.3f} p95 {result['ttft_p95']:.3f} max {result['ttft_max']:.3f}")
    log(f"[stream] {label}: {ticks} fabric ticks, {fab.router.scan_steps} router scan steps, "
        f"{fab.frames_routed} frames; host ms per tick: fabric (exchange_async + poll) "
        f"{result['fabric_ms_tick']:.3f} (exchange_async {result['exchange_ms_tick']:.3f}), "
        f"serve wall {result['wall_ms_tick']:.3f}; poll() "
        f"wait {result['poll_ms']:.3f} ms per call over {len(polls)} calls (max "
        f"{1e3 * max(polls, default=0.0):.3f}); launches {launches}")
    log(f"[stream] {label}: lane flushes: {len(flush_s)} calls of flush_lanes ({shipping} "
        f"shipped, the drain included), B7 chunk_bursts launches {result['b7']} "
        f"({result['b7_tick']:.3f} per tick), padded-form launches 0; host ms per tick in "
        f"lane flushes {result['flush_ms_tick']:.3f} (max per call "
        f"{1e3 * max(flush_s, default=0.0):.3f})")
    return launches, made, result, bursts


def phase_streaming(dev, params, cfg, wires, base):
    """Phase 7: the streaming plane, overlap and logprobs on, then both off.
    Returns each run's launches, the B7 calls of both, and their numbers."""
    runs = [streaming_run(dev, params, cfg, wires, base, overlap=True, logprobs=True),
            streaming_run(dev, params, cfg, wires, base, overlap=False, logprobs=False)]
    a, b = runs[0][2], runs[1][2]
    log(f"[stream] overlap on / off: wall {a['s']:.3f} / {b['s']:.3f} s; poll() wait per "
        f"tick {a['poll_ms']:.3f} / {b['poll_ms']:.3f} ms; fabric host ms per tick "
        f"{a['fabric_ms_tick']:.3f} / {b['fabric_ms_tick']:.3f}; lane flushes host ms per "
        f"tick {a['flush_ms_tick']:.3f} / {b['flush_ms_tick']:.3f}")
    calls = [args for r in runs for name, args in r[1] if name == "chunk_bursts"]
    framing = [args for r in runs for name, args in r[1] if name == "frame_batch"]
    return [r[0] for r in runs], calls, framing, [x for r in runs for x in r[3]]


def tick_split(events) -> dict:
    """The trace's own split of the streaming serve's compute ticks: the
    ``serve.tick`` time, the part of it that ``fabric.tick`` events cover
    (a fabric tick runs from its dispatch to its readback, so in the
    overlapped pipeline it spans the next tick's decode), and the rest, in
    ms per serve tick; and the mean ``fabric.tick``."""
    def spans(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name]

    serve_t, fabric_t = spans("serve.tick"), spans("fabric.tick")
    covered = sum(max(0.0, min(b, d) - max(a, c)) for a, b in serve_t for c, d in fabric_t)
    total = sum(b - a for a, b in serve_t)
    n = max(1, len(serve_t))
    return {"serve_ticks": len(serve_t), "fabric_ticks": len(fabric_t),
            "serve_ms": total / n / 1e3, "fabric_in_serve_ms": covered / n / 1e3,
            "rest_ms": (total - covered) / n / 1e3,
            "fabric_ms": sum(d - c for c, d in fabric_t) / max(1, len(fabric_t)) / 1e3}


def run_clis(commands) -> None:
    """Run ``python -m <module> <args>`` for each command, all at once,
    from ``repro_torch`` alone (PYTHONPATH is the checkout's ``src``); each
    must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [(cmd, subprocess.Popen([sys.executable, "-m", *cmd], env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
             for cmd in commands]
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate(timeout=300)
            lines = out.strip().splitlines()
            check(proc.returncode == 0,
                  f"python -m {' '.join(cmd)} exited {proc.returncode}:\n{out[-2000:]}")
            log(f"[telemetry] python -m {' '.join(cmd[:2])}: exit 0, {len(lines)} lines, "
                f"last: {lines[-1] if lines else ''}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@contextlib.contextmanager
def timed_calls(targets):
    """Sum the host time spent inside the given methods and functions
    (``(owner, names)`` pairs), outermost calls only, while the block runs;
    yields ``{"s": seconds, "calls": n}``."""
    acc, depth = {"s": 0.0, "calls": 0}, [0]

    def timed(inner):
        def call(*a, **k):
            if depth[0]:
                return inner(*a, **k)
            depth[0] += 1
            t = time.perf_counter()
            try:
                return inner(*a, **k)
            finally:
                acc["s"] += time.perf_counter() - t
                acc["calls"] += 1
                depth[0] -= 1
        return call

    with contextlib.ExitStack() as stack:
        for owner, names in targets:
            for name in names:
                stack.enter_context(mock.patch.object(owner, name, timed(getattr(owner, name))))
        yield acc


def phase_telemetry(dev, params, cfg, wires, base, card: str, sharded_launches: dict):
    """Phase 11: the streaming serve untraced, with metrics, trace, spans
    and analyze=True twice, and untraced again (off, on, on, off), and the
    sharded serve with analyze=True and a trace; their checks, numbers and
    the analysis and obs CLIs.  Returns every run's launches."""
    from repro_torch.analysis import fabric_passes
    from repro_torch.obs import (MetricsRegistry, SpanTracker, TraceRecorder,
                                 environment_meta, evaluate_slo, tick_breakdown,
                                 validate_snapshot, validate_trace)

    # the telemetry entry points the serve and the fabric call when it is on
    hooks = [(TraceRecorder, ("now_us", "instant", "complete", "counter")),
             (SpanTracker, ("start", "event", "finish", "degrade", "add_component",
                            "anomaly", "set_tick")),
             (fabric_passes, ("analyze_sends",))]
    runs, inside = [], []
    for traced in (False, True, True, False):
        tel = None
        if traced:
            trace = TraceRecorder()
            tel = dict(trace=trace, spans=SpanTracker(trace), metrics=MetricsRegistry(),
                       analyze=True)
        with timed_calls(hooks) as acc:
            runs.append((streaming_run(dev, params, cfg, wires, base, overlap=True,
                                       logprobs=True, telemetry=tel), tel))
        if traced:
            inside.append(acc)
    off, on = runs[0][0], runs[1][0]
    trace, spans, metrics = (runs[1][1][k] for k in ("trace", "spans", "metrics"))
    # every run's wires equal the batched plane's (streaming_run), so each other's
    for (run, _) in runs[1:]:
        check(run[0] == off[0], f"telemetry changed the launches: {run[0]} vs {off[0]}")
        for key in ("ticks", "exchanges", "exchange_async_n", "polls_n"):
            check(run[2][key] == off[2][key], f"telemetry changed the {key}: "
                                              f"{run[2][key]} vs {off[2][key]}")
    reqs = spans.requests()
    check(len(reqs) == len(wires) and not spans.anomalies, "spans: not one per request")
    for sp in reqs:
        names = [e.name for e in sp.events]
        check(names[0] == "request" and sp.done and not sp.degraded
              and "serve.first_token" in names and "fabric.deliver" in names,
              f"span {sp.rid}: {names}")
        bd = tick_breakdown(sp)
        check(sum(v for k, v in bd.items() if k != "ttft_ticks") == bd["ttft_ticks"]
              == sp.first_tick("serve.first_token") - sp.first_tick("serve.ingress"),
              f"span {sp.rid}: tick breakdown {bd} does not add up")
    obj = trace.to_json()
    check(validate_trace(obj) == [], "trace does not validate")
    snap = metrics.snapshot()
    snap["meta"] = meta = environment_meta()
    check(validate_snapshot(snap) == [], "metrics snapshot does not validate")
    check(meta["platform"] == "gpu" and meta["backend"] == "cuda"
          and meta["device_kind"] == torch.cuda.get_device_name(0),
          f"environment_meta does not name the card: {meta}")
    slo = evaluate_slo(SLO_SPEC, snapshot=snap)
    check(len(slo.results) == 4 and all(r.observed is not None for r in slo.results),
          f"SLO report incomplete: {slo.render_text()}")
    for line in slo.render_text().splitlines():
        log(f"[telemetry] {line}")
    split = tick_split(obj["traceEvents"])
    check(split["fabric_ticks"] == on[2]["exchanges"], "not one fabric.tick per fabric tick")
    by_name = {}
    for e in obj["traceEvents"]:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    ticks = on[2]["ticks"]
    order = ", ".join(f"{'on' if tel else 'off'} {run[2]['wall_ms_tick']:.3f} (fabric "
                      f"{run[2]['fabric_ms_tick']:.3f})" for run, tel in runs)
    log(f"[telemetry] streaming serve, host ms per tick in run order: {order}; {ticks} ticks "
        f"each, the same launches and tick calls; {card}")
    log(f"[telemetry] host ms per tick inside the telemetry calls (trace, spans, "
        f"analyze_sends; outermost calls, timed on the host clock): "
        + ", ".join(f"{1e3 * a['s'] / ticks:.3f} ({a['calls'] / ticks:.1f} calls)"
                    for a in inside) + f"; {card}")
    log(f"[telemetry] trace: {len(obj['traceEvents'])} events, "
        f"{len(obj['traceEvents']) / ticks:.2f} per tick "
        f"({', '.join(f'{k} {v}' for k, v in sorted(by_name.items()))}); "
        f"{len(reqs)} request spans, environment_meta {meta['device_kind']}; {card}")
    log(f"[telemetry] trace split of a streaming tick: serve.tick "
        f"{split['serve_ms']:.3f} ms ({split['serve_ticks']} ticks), fabric.tick inside it "
        f"{split['fabric_in_serve_ms']:.3f} ms, the rest {split['rest_ms']:.3f} ms; "
        f"fabric.tick mean {split['fabric_ms']:.3f} ms ({split['fabric_ticks']} ticks, "
        f"dispatch to readback); {card}")

    strace = TraceRecorder()
    s_launches, _, sfab = sharded_run(dev, params, cfg, wires, base, None,
                                      "default placement traced",
                                      telemetry=dict(trace=strace, analyze=True))
    check(s_launches == sharded_launches,
          f"telemetry changed the sharded launches: {s_launches} vs {sharded_launches}")
    s_ticks = [e for e in strace.events if e["name"] == "fabric.tick"]
    check(validate_trace(strace.to_json()) == [] and len(s_ticks) == sfab.exchanges,
          "sharded trace: invalid, or not one fabric.tick per fabric tick")
    log(f"[telemetry] sharded serve traced and analyzed: every response == the batched "
        f"plane's, launches == the untraced run's; fabric.tick mean "
        f"{sum(e['dur'] for e in s_ticks) / len(s_ticks) / 1e3:.3f} ms over {len(s_ticks)} "
        f"ticks; {card}")

    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: str(Path(tmp) / f"{k}.json") for k in ("metrics", "trace", "spans")}
        Path(paths["metrics"]).write_text(json.dumps(snap))
        trace.save(paths["trace"])
        Path(paths["spans"]).write_text(json.dumps(spans.export()))
        run_clis([
            ["repro_torch.analysis", "--strict", "--json", str(Path(tmp) / "findings.json")],
            ["repro_torch.obs", paths["metrics"], "--validate"],
            ["repro_torch.obs", paths["metrics"]],
            ["repro_torch.obs", paths["trace"], "--validate"],
            ["repro_torch.obs", "slo", SLO_SPEC, "--metrics", paths["metrics"]],
            ["repro_torch.obs", "attribution", paths["spans"]],
        ])
    return [run[0] for run, _ in runs] + [s_launches]


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


def library_bursts_ms(calls, reps: int) -> float:
    """``torch.where``, ``torch.cat`` and ``index_select`` of the live words
    (the column index and the live words' flat index are inputs): the
    PyTorch calls that compute the trimmed rows, checked equal first."""
    prep = []
    for meta, toks, counts, ew, _, _ in calls:
        cap_w = toks.shape[1]
        col = torch.arange(cap_w + 4, device=toks.device)
        live = counts * ew
        keep = (col[None] < 3 + live) | (col[None] == cap_w + 3)
        prep.append((col[None, :cap_w], torch.nonzero(keep.reshape(-1))[:, 0]))

    def run_all():
        return [torch.cat([m, torch.where(col < c * e, t, 0), c], -1).reshape(-1)
                .index_select(0, idx) for (m, t, c, e, _, _), (col, idx) in zip(calls, prep)]

    check(all(same(x, fp.chunk_bursts(*a)) for x, a in zip(run_all(), calls)),
          "chunk_bursts: library calls differ")
    return time_ms(run_all, reps)


def burst_large(dev, g):
    """BURST_LARGE rows of 64 element words' capacity, elem_words 1 or 2 per
    row, seeded counts up to the capacity, and their prefix sum."""
    rows, cap_w = BURST_LARGE
    ew = torch.randint(1, 3, (rows, 1), dtype=torch.int32, device=dev, generator=g)
    counts = (torch.rand((rows, 1), device=dev, generator=g) * (cap_w // ew + 1)).int()
    meta = torch.randint(-2**31, 2**31, (rows, 3), dtype=torch.int32, device=dev, generator=g)
    toks = torch.randint(-2**31, 2**31, (rows, cap_w), dtype=torch.int32, device=dev,
                         generator=g)
    lengths = (counts.long() * ew)[:, 0] + 4
    return (meta, toks, counts, ew, torch.cumsum(lengths, 0) - lengths, int(lengths.sum()))


def phase_chunk_kernel(dev, padded_calls, burst_calls):
    """Phase 9: B7's padded form == plain at the calls phase 10 made and at
    the two large shapes (masked; the first also unmasked), and its trimmed
    form == plain at the streaming serves' calls and at BURST_LARGE."""
    rows = {}
    g = torch.Generator(device=dev).manual_seed(13)
    for name, calls, library, lib_label in (
            ("pack_chunks_batch", padded_calls, library_chunks_ms, "where/cat"),
            ("chunk_bursts", burst_calls, library_bursts_ms, "where/cat/index_select")):
        where = "phase 10's re-encode" if name == "pack_chunks_batch" else "the streaming path"
        check(len(calls) >= 1, f"{name}: no call recorded on {where}")
        m = measure(name, calls, reps=20)
        m["library_ms"] = library(calls, 20)
        shapes = sorted({(tuple(a[1].shape), a[3] if name == "pack_chunks_batch" else "per row")
                         for a in calls})
        log(f"[kernels] {name}: {len(calls)} recorded calls of {where}, (tokens shape, "
            f"elem_words) {shapes[:8]}" + (" ..." if len(shapes) > 8 else ""))
        if name == "pack_chunks_batch":
            large = []
            for n, cap, ew in CHUNK_LARGE:
                meta = torch.randint(-2**31, 2**31, (n, 3), dtype=torch.int32, device=dev,
                                     generator=g)
                toks = torch.randint(-2**31, 2**31, (n, cap * ew), dtype=torch.int32,
                                     device=dev, generator=g)
                counts = torch.randint(0, cap + 1, (n, 1), dtype=torch.int32, device=dev,
                                       generator=g)
                large.append((f"{n} x cap {cap} x {ew} words, masked",
                              [(meta, toks, counts, ew)]))
                if ew == 1:
                    large.append((f"{n} x cap {cap}, unmasked", [(meta, toks, counts, 0)]))
        else:
            large = [(f"{BURST_LARGE[0]} x {BURST_LARGE[1]} words, ew 1|2",
                      [burst_large(dev, g)])]
        err = m["max_abs_err"]
        for label, lc in [("main-path shapes", None)] + large:
            r = m if lc is None else measure(name, lc, reps=20)
            if lc is not None:
                r["library_ms"] = library(lc, 20)
            err = max(err, r["max_abs_err"])
            log(f"[kernels] {name:17s} {label:34s} kernel {r['ms']:.4f} ms  bound "
                f"{r['bound_ms']:.4f} ms ({r['bytes']} B)  plain {r['plain_ms']:.4f} ms  "
                f"{lib_label} {r['library_ms']:.4f} ms  max_abs_err {r['max_abs_err']}")
        rows[name] = {"main": m, "large": {"max_abs_err": err}}
        del large
        torch.cuda.empty_cache()
    return rows


def framed_stream(schema_json: dict, msg: dict):
    """The host HW-to-HW SER stream of ``msg`` at the paper's frame size
    (500 phits of 16 bytes) and the header table its framer wrote: int32
    rows ``[word, size, list_level]``.  The framer is swapped for one that
    notes where each header goes (scaffolding of this script)."""
    writers = []

    class NotingFrameWriter(FrameWriter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.rows = []
            writers.append(self)

        def _note(self, size: int, level: int) -> None:
            self._align_out()  # the header starts on a phit
            self.rows.append((len(self.out) // 4, size, level))

        def flush(self) -> None:
            if self.buf:
                self._note(len(self.buf), self.level)
            super().flush()

        def end_list(self, level: int) -> None:
            self.flush()
            self._note(0, level)
            super().end_list(level)

    schema = Schema.from_json(schema_json)
    with mock.patch.object(host_fsm, "FrameWriter", NotingFrameWriter):
        res = SerFSM(build_rom(schema), "hw2hw").run(
            strip_for_ser(msg_to_des_tokens(schema, msg)))
    (writer,) = writers
    check(res.frames == len(writer.rows), "framer noted a header per frame")
    return res.wire, np.array(writer.rows, np.int32).reshape(-1, 3)


def serial_stamp(wire: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The reference's serial stamp (``ref.stamp_headers_ref``), with words
    outside the wire dropped (the port's rule)."""
    out = wire.copy()
    for word, size, level in rows:
        for slot, v in ((int(word), size), (int(word) + 1, level)):
            if 0 <= slot < out.shape[0]:
                out[slot] = v
    return out


def token_runs(plan, path: str):
    """(first row, rows, base byte) of each uniform run of 4-byte tokens
    of ``path`` (one per token List of the message)."""
    offs = plan.offsets[path][:plan.counts[path]].astype(np.int64)
    cut = np.flatnonzero(np.diff(offs) != 4) + 1
    starts, ends = np.r_[0, cut], np.r_[cut, len(offs)]
    return [(int(a), int(b - a), int(offs[a])) for a, b in zip(starts, ends) if b > a]


def ser_round_trips(dev, wires, answers, rec_plan, rec_lanes, rec_wire):
    """Phase 10's path: the serve's wires and the record wire through
    decode_message_kernel and encode_message, and every token run of the
    serve's wires through encode_run (B4); returns the count of wires."""
    for schema, tok_path, ws in ((request_schema(), "prompts.elem.tokens.elem", wires),
                                 (response_schema(), "outputs.elem.tokens.elem", answers)):
        for w in ws:
            plan = plan_from_wire(schema, w)
            lanes = ops.wire_to_u32(w, dev)
            dec = ops.decode_message_kernel(lanes, plan)
            check(bytes(encode_message(len(w), plan, dec).cpu().numpy()) == w,
                  "encode_message did not give back a serve wire")
            for row, n, base in token_runs(plan, tok_path):
                run = ops.encode_run(dec[tok_path][row:row + n], 4, 4)
                check(torch.equal(run, lanes[base // 4:base // 4 + n]),
                      "encode_run did not give back a token run of a serve wire")
    dec = ops.decode_message_kernel(rec_lanes, rec_plan)
    want = torch.from_numpy(np.frombuffer(rec_wire, np.uint8).copy()).to(dev)
    check(torch.equal(encode_message(len(rec_wire), rec_plan, dec), want),
          "encode_message did not give back the record wire")
    return len(wires) + len(answers) + 1


def reencode_bursts(dev, bursts) -> int:
    """Every burst phase 7's lanes shipped, packed again on the card by
    ``encode_fragment_burst`` (B7's padded form) and by the host codec
    (``encode_fragment`` per fragment): both must be the served burst.
    Returns the fragments re-encoded."""
    n = 0
    for plan, chunks, served in bursts:
        host = b"".join(stream_plans.encode_fragment(plan, c.stream_id, c.step, c.tokens,
                                                     c.eos) for c in chunks)
        check(stream_plans.encode_fragment_burst(plan, chunks, dev) == host == served,
              "encode_fragment_burst on the card != the host codec != the served burst")
        n += len(chunks)
    return n


def phase_device_ser(dev, wires, base, rec_plan, rec_lanes, rec_wire, recs, bursts):
    """Phase 10: the device-side SER entry points on the card (the serve's
    wires, the record wire, encode_run at 256 MiB, write_headers on a framed
    stream, the streamed bursts through encode_fragment_burst), then B4 and
    B8 == plain at those calls and at large shapes.  Returns the path's
    launches, the kernels' rows and the padded B7 calls (recorded)."""
    answers = []
    for rw in base:  # the served answers, in the SW->HW layout plan_from_wire reads
        rid, outs = serve.decode_response(rw)
        answers.append(ser_sw_to_hw(response_schema(),
                                    {"req_id": rid, "outputs": [{"tokens": o} for o in outs]}))
    msg = {"hdr": 0xABCDEF, "recs": [int.from_bytes(r.tobytes(), "little") for r in recs]}
    t0 = time.perf_counter()
    stream, table = framed_stream(RECORD_LIST_SCHEMA, msg)
    log(f"[ser] host hw2hw SER of {len(recs)} records: {len(stream)} B, {len(table)} frames "
        f"in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(17)
    big = [(torch.randint(-2**31, 2**31, (n, (nb + 3) // 4), dtype=torch.int32, device=dev,
                          generator=g), stride, nb) for n, nb, stride in PACK_LARGE]

    reset_launches()
    t0 = time.perf_counter()
    with fp.recording() as made:
        n_wires = ser_round_trips(dev, wires, answers, rec_plan, rec_lanes, rec_wire)
        for toks, stride, nb in big:
            wire = ops.encode_run(toks, stride, nb)
            back = ops.decode_run(wire, 0, stride, toks.shape[0], nb)
            check(torch.equal(back, toks & lane_mask_i32(nb, dev)),
                  f"encode_run -> decode_run ({nb} bytes at {stride}) != masked tokens")
            del wire, back
        host = ops.wire_to_u32(stream, dev)
        words = torch.from_numpy(table[:, 0].astype(np.int64)).to(dev)
        zeroed = host.clone()
        zeroed[torch.cat([words, words + 1])] = 0
        check(not torch.equal(zeroed, host), "zeroing the header words changed nothing")
        check(torch.equal(ops.write_headers(zeroed, torch.from_numpy(table).to(dev)), host),
              "write_headers did not give back the host framed stream")
        w0, w1 = int(table[0, 0]), int(table[1, 0])
        for label, extra in (("repeated", [w0, 77, 9]), ("overlapping", [w1 + 1, 55, 66])):
            rows = np.vstack([table, np.array([extra], np.int32)])
            got = ops.write_headers(zeroed, torch.from_numpy(rows).to(dev))
            check(np.array_equal(lanes_u32(got), serial_stamp(lanes_u32(zeroed), rows)),
                  f"write_headers with a {label} word != the serial stamp")
        n_frags = reencode_bursts(dev, bursts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    for name in SER_KERNELS:
        check(launches[name] >= 1, f"device SER launched no {name}")
    check(launches["stamp_headers"] == 3, "write_headers did not launch once a call")
    check(launches["pack_chunks_batch"] == len(bursts) >= 1,
          "encode_fragment_burst did not launch once a burst")
    log(f"[ser] {n_wires} wires ({len(wires)} requests, {len(answers)} answers, 1 of "
        f"{len(recs)} records) re-encoded byte for byte; encode_run -> decode_run == masked "
        f"tokens at {[(n, nb, stride) for n, nb, stride in PACK_LARGE]} (rows, bytes, pitch); "
        f"framed stream ({len(table)} headers) re-stamped byte for byte, repeated and "
        f"overlapping words == serial stamp; {len(bursts)} streamed bursts ({n_frags} "
        f"fragments) re-packed by encode_fragment_burst == host codec == served; {dt:.3f} s; "
        f"launches {launches}")

    calls = {name: [a for k, a in made if k == name] for name in SER_KERNELS}
    for name in SER_KERNELS:
        shapes = sorted({tuple(tuple(t.shape) if isinstance(t, torch.Tensor) else t
                               for t in a) for a in calls[name]})
        log(f"[kernels] {name}: {len(calls[name])} recorded calls, shapes {shapes[:4]}"
            + (" ..." if len(shapes) > 4 else ""))
    big_w = torch.randint(-2**31, 2**31, (STAMP_LARGE_WORDS,), dtype=torch.int32,
                          device=dev, generator=g)
    spread = STAMP_LARGE_WORDS // STAMP_LARGE_HEADERS
    big_h = torch.randint(-2**31, 2**31, (STAMP_LARGE_HEADERS, 3), dtype=torch.int32,
                          device=dev, generator=g)
    big_h[:, 0] = (torch.arange(STAMP_LARGE_HEADERS, device=dev) * spread + torch.randint(
        0, spread - 1, (STAMP_LARGE_HEADERS,), device=dev, generator=g)).int()
    # (kernel, label, calls, reps, with a library call); the first row of
    # each kernel is its main-path row: B4 at the serve wires' token runs,
    # B8 at the framed stream (the repeated and overlapping tables have no
    # library route: index_put_ needs distinct words).  B8's large table is
    # ordered, as a framer writes it; shuffled, the kernel takes its owner
    # pass
    cases = [("pack_run", "main-path shapes (serve runs)", calls["pack_run"][:-len(PACK_LARGE)],
              50, True)]
    cases += [("pack_run", f"{a[0].shape[0]} rows x {a[2]} B at {a[1]}", [a], 20, True)
              for a in calls["pack_run"][-len(PACK_LARGE):]]
    cases += [("stamp_headers", "main-path shapes (framed stream)", calls["stamp_headers"][:1],
               200, True),
              ("stamp_headers", "repeated and overlapping words", calls["stamp_headers"][1:],
               200, False),
              ("stamp_headers", f"{STAMP_LARGE_WORDS} words, {STAMP_LARGE_HEADERS} headers",
               [(big_w, big_h)], 20, True),
              ("stamp_headers", "the same table shuffled (owner pass)",
               [(big_w, big_h[torch.randperm(STAMP_LARGE_HEADERS, device=dev,
                                             generator=g)])], 20, True)]
    rows = {}
    for name, label, lc, reps, with_library in cases:
        r = measure(name, lc, reps)
        r["library_ms"] = library_ser_ms(name, lc, reps) if with_library else None
        if name not in rows:
            rows[name] = {"main": r, "large": {"max_abs_err": 0}}
        big_err = rows[name]["large"]["max_abs_err"]
        rows[name]["large"]["max_abs_err"] = max(big_err, r["max_abs_err"])
        lib = f"{r['library_ms']:.4f} ms" if with_library else "none"
        log(f"[kernels] {name:14s} {label:34s} kernel {r['ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bytes']} B)  plain {r['plain_ms']:.4f} ms  "
            f"{SER_LIBRARY[name]} {lib}  max_abs_err {r['max_abs_err']}")
    padded = [a for k, a in made if k == "pack_chunks_batch"]
    del big, big_w, big_h, calls, made
    torch.cuda.empty_cache()
    return launches, rows, padded


SER_LIBRARY = {"pack_run": "F.pad(tokens & mask)", "stamp_headers": "clone + index_put_"}


def library_ser_ms(name: str, calls, reps: int) -> float:
    """One PyTorch call each that computes the same function, checked equal
    to the kernel first: ``F.pad`` of the masked tokens (B4; the mask is an
    input), or ``clone()`` and ``index_put_`` (B8; only for tables of
    distinct words, since ``index_put_`` on CUDA does not promise that the
    last duplicate wins)."""
    if name == "pack_run":
        masks = {a[2]: lane_mask_i32(a[2], a[0].device) for a in calls}

        def run_all():
            return [torch.nn.functional.pad(t & masks[nb], (0, stride // 4 - t.shape[1]))
                    .reshape(-1) for t, stride, nb in calls]
    else:
        idx = []
        for _, hdr in calls:
            word = hdr[:, 0].long()
            slots = torch.cat([word, word + 1])
            check(slots.unique().numel() == slots.numel(), "index_put_ needs distinct words")
            idx.append(((slots,), torch.cat([hdr[:, 1], hdr[:, 2]])))

        def run_all():
            return [w.clone().index_put_(*ix) for (w, _), ix in zip(calls, idx)]
    check(all(torch.equal(x, KERNELS[name][3](*a)) for x, a in zip(run_all(), calls)),
          f"{name}: library calls differ")
    return time_ms(run_all, reps)


# ---------------------------------------------------------------------------
# phase 12: the model families
# ---------------------------------------------------------------------------


def hold_recorded(des_calls, frame_calls) -> None:
    """Each kernel == its plain version, bit for bit, at the calls a serve
    made (as the wrappers recorded them)."""
    calls = [(name, (wire,) + tuple(args)) for name, wire, args in des_calls]
    calls += [(name, tuple(args)) for name, args in frame_calls]
    for name, args in calls:
        _, _, plain, wrapper, _ = KERNELS[name]
        check(same(wrapper(*args), plain(*args)), f"{name} != plain at a recorded serve call")
    torch.cuda.synchronize()


def counted_serve(fn):
    """Run one serve with the launch counts set to 0 before it and read
    after it, the kernels' calls recorded; returns (responses, launches,
    DES calls, frame calls, seconds, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with pu.recording() as des_calls, fp.recording() as frame_calls:
        resp = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(launches["unpack_run_aligned"] >= 1 and launches["unpack_gather"] >= 1,
          "a family serve launched no unpack_run_aligned / unpack_gather")
    return (resp, launches, des_calls, frame_calls, dt,
            torch.cuda.max_memory_allocated() / 2**30)


def served_batch(cfg, wires, pad_to: int, rows: int, dev) -> dict:
    """The batch the first admit serves: the first ``rows`` prompts,
    right-padded with 0 as the scheduler pads them, and the family's zero
    placeholder (none for an lm)."""
    prompts = [p for w in wires for p in serve.decode_request(w)[1]][:rows]
    toks = np.zeros((rows, pad_to), np.int32)
    for j, p in enumerate(prompts):
        toks[j, :min(len(p), pad_to)] = p[:pad_to]
    batch = extra_inputs(cfg, rows, dev)
    batch["tokens"] = torch.from_numpy(toks).to(dev)
    return batch


def served_batch_aux(params, cfg, wires, pad_to: int, rows: int):
    """One extra prefill of the batch the first admit serves; checks its
    logits and returns forward's ``aux``."""
    with torch.no_grad():
        logits, _, aux = model_forward(params, cfg, served_batch(
            cfg, wires, pad_to, rows, params.embed.device), last_only=True)
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
        rows, 1, cfg.padded_vocab), f"{cfg.name}: prefill logits not finite / wrong shape")
    return {k: float(v) for k, v in aux.items()}


def serve_and_step_times(dev, params, cfg, wires):
    """Phase 12's serve of ``wires`` (after a one-wire warm-up), counted
    and held to the plain kernels at its recorded calls, then the prefill
    step (``SLOTS`` x ``PAD_TO`` seeded tokens, the family's placeholder)
    and the decode step timed by CUDA events.  Returns (responses,
    launches, DES calls, tokens out, seconds, peak GiB, prefill ms, decode
    ms, K/V rows per slot, the decode step's read bound in ms: every weight
    and the whole slot cache read once at the card's memory rate)."""
    kw = dict(pad_to=PAD_TO, slots=SLOTS, device=dev)
    serve.serve_requests(params, cfg, wires[:1], max_new=2, **kw)  # warm-up
    resp, launches, des_calls, frame_calls, dt, peak = counted_serve(
        lambda: serve.serve_requests(params, cfg, wires, max_new=FAMILY_MAX_NEW, **kw))
    hold_recorded(des_calls, frame_calls)
    n_out = check_responses(cfg, resp, FAMILY_MAX_NEW)

    prefill_step, decode_step = cached_serve_steps(cfg, cache_len=PAD_TO + FAMILY_MAX_NEW)
    g = torch.Generator(device=dev).manual_seed(5)
    batch = extra_inputs(cfg, SLOTS, dev)
    batch["tokens"] = torch.randint(2, cfg.vocab, (SLOTS, PAD_TO), dtype=torch.int32,
                                    device=dev, generator=g)
    pf_ms = time_ms(lambda: prefill_step(params, batch), reps=2, warmup=1)
    state = dict(zip(("tok", "cache"), prefill_step(params, batch)))
    kv_rows = next((c["k"].shape[1] for c in state["cache"]["layers"] if "k" in c), 0)
    read = sum(p.numel() * p.element_size() for p in params.parameters())
    read += sum(t.numel() * t.element_size() for _, t in leaf_paths(state["cache"]))

    def one_decode():
        state["tok"], state["cache"] = decode_step(params, state["cache"], state["tok"])

    dec_ms = time_ms(one_decode, reps=8, warmup=2)
    return (resp, launches, des_calls, n_out, dt, peak, pf_ms, dec_ms, kv_rows,
            read / HBM_BYTES_PER_S * 1e3)


def family_smoke(dev, arch: str) -> None:
    """The float32 smoke model, same seeded parameters: the card serves the
    host's bytes."""
    scfg = smoke_config(get_config(arch))
    sp_cpu = init_params(scfg, torch.Generator().manual_seed(0), "cpu")
    sp_gpu = init_params(scfg, torch.Generator().manual_seed(0), "cpu").to(dev)
    swires = serve.synthetic_wires(scfg, 4, 3, seed=3)
    kw = dict(max_new=6, pad_to=16, slots=4)
    check(serve.serve_requests(sp_gpu, scfg, swires, device=dev, **kw)
          == serve.serve_requests(sp_cpu, scfg, swires, device="cpu", **kw),
          f"smoke {arch}: card and host responses differ")


def family_run(dev, card: str, arch: str) -> list:
    """One architecture at full width and its cut depth: the smoke check,
    then init, a warm-up, the counted serve, step times and one extra
    prefill for ``aux``; mixtral also serves long prompts, xlstm also the
    sharded plane.  Returns each counted serve's launches."""
    family_smoke(dev, arch)
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=FAMILY_LAYERS[arch])
    wires = serve.synthetic_wires(cfg, FAMILY_REQUESTS, N_PROMPTS, SEED, *PROMPT_LENS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    log(f"[families] {arch}: {cfg.n_layers} of {full.n_layers} layers "
        f"{list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))[:8]}, d{cfg.d_model}, "
        f"{n_params} params ({2 * n_params / 2**30:.2f} GiB as bf16), init "
        f"{time.perf_counter() - t0:.2f} s; smoke model: card == host bytes")
    resp, launches, des_calls, n_out, dt, peak, pf_ms, dec_ms, _, read_ms = (
        serve_and_step_times(dev, params, cfg, wires))
    out = [launches]
    log(f"[families] {arch} | {card} | serve_requests: {len(wires)} requests, {n_out} "
        f"tokens in {dt:.3f} s: {len(wires) / dt:.3f} req/s, {n_out / dt:.1f} tok/s | "
        f"prefill step ({SLOTS}x{PAD_TO}) {pf_ms:.3f} ms, decode step ({SLOTS} slots) "
        f"{dec_ms:.3f} ms against a {read_ms:.3f} ms read bound (weights and slot cache "
        f"at 3.35 TB/s) | peak {peak:.2f} GiB | launches {launches}; kernel DES == plain "
        f"at the {len(des_calls)} recorded calls")
    aux = served_batch_aux(params, cfg, wires, PAD_TO, SLOTS)
    if aux:
        log(f"[families] {arch} | {card} | moe_dropped {aux['moe_dropped']:.6f}, "
            f"moe_balance_loss {aux['moe_balance_loss']:.6f} (forward's aux, one extra "
            f"prefill of the served {SLOTS}x{PAD_TO} batch)")

    if arch == "mixtral-8x22b":
        lwires = serve.synthetic_wires(cfg, 1, N_PROMPTS, SEED + 1, *LONG_PROMPT_LENS)
        lkw = dict(pad_to=LONG_PAD_TO, slots=LONG_SLOTS, device=dev)
        resp, launches, des_calls, frame_calls, dt, peak = counted_serve(
            lambda: serve.serve_requests(params, cfg, lwires, max_new=FAMILY_MAX_NEW, **lkw))
        hold_recorded(des_calls, frame_calls)
        n_out = check_responses(cfg, resp, FAMILY_MAX_NEW)
        out.append(launches)
        aux = served_batch_aux(params, cfg, lwires, LONG_PAD_TO, LONG_SLOTS)
        log(f"[families] {arch} long | {card} | serve_requests: 1 request of {N_PROMPTS} "
            f"prompts of {LONG_PROMPT_LENS[0]}-{LONG_PROMPT_LENS[1] - 1} tokens, pad_to "
            f"{LONG_PAD_TO} (window {cfg.window}), {LONG_SLOTS} slots: {n_out} tokens in "
            f"{dt:.3f} s, {n_out / dt:.1f} tok/s | peak {peak:.2f} GiB | moe_dropped "
            f"{aux['moe_dropped']:.6f}, moe_balance_loss {aux['moe_balance_loss']:.6f} "
            f"({LONG_SLOTS * LONG_PAD_TO // 8192} dispatch groups of 8192)")

    if arch == "xlstm-125m":
        with pu.recording() as des_calls:
            launches, frame_calls, _ = sharded_run(
                dev, params, cfg, wires, resp,
                [1 + i % N_SHARDS for i in range(len(wires))], "xlstm-125m round-robin",
                max_new=FAMILY_MAX_NEW)
        check(launches["unpack_run_aligned"] >= 1 and launches["unpack_gather"] >= 1,
              "xlstm sharded serve launched no unpack_run_aligned / unpack_gather")
        hold_recorded(des_calls, frame_calls)
        out.append(launches)
        log(f"[families] {arch} | {card} | serve_requests_sharded ({N_SHARDS} shards): every "
            f"response == the batched plane's")
    del params
    torch.cuda.empty_cache()
    return out


def phase_families(dev, card: str) -> list:
    """Phase 12: every other lm architecture served at full width."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = []
    for arch in FAMILY_LAYERS:
        launches += family_run(dev, card, arch)
    log(f"[families] phase 12: {len(FAMILY_LAYERS)} architectures in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the vlm and encdec families
# ---------------------------------------------------------------------------


def modality_reaches_logits(params, cfg, batch: dict) -> float:
    """One extra prefill of the served batch with seeded non-zero
    ``vision``/``audio`` (a generator on the card): its logits must be
    finite and differ from the zero-placeholder prefill's, which shows
    the prefix or the encoder is on the path.  Returns the largest
    difference."""
    g = torch.Generator(device=batch["tokens"].device).manual_seed(SEED + 7)
    seeded = {k: v if k == "tokens" else torch.randn(v.shape, generator=g, device=v.device)
              for k, v in batch.items()}
    with torch.no_grad():
        zero = model_forward(params, cfg, batch, last_only=True)[0]
        live = model_forward(params, cfg, seeded, last_only=True)[0]
    rows = batch["tokens"].shape[0]
    for name, lg in (("zero", zero), ("seeded", live)):
        check(bool(torch.isfinite(lg).all()) and tuple(lg.shape) == (
            rows, 1, cfg.padded_vocab), f"{cfg.name}: {name} prefill logits not finite / "
                                        f"wrong shape")
    diff = float((live - zero).abs().max())
    check(diff > 0, f"{cfg.name}: seeded {sorted(set(batch) - {'tokens'})} left the "
                    f"logits unchanged")
    return diff


def multimodal_run(dev, card: str, arch: str) -> list:
    """One vlm or encdec architecture at full width and full depth: the
    smoke check, init, a warm-up, the counted serve, step times, the
    modality check, then the sharded plane (round-robin) and, for
    whisper, the streaming plane with overlap and logprobs, each held to
    the batched plane's bytes.  Returns each counted serve's launches."""
    family_smoke(dev, arch)
    cfg = get_config(arch)
    wires = serve.synthetic_wires(cfg, FAMILY_REQUESTS, N_PROMPTS, SEED, *PROMPT_LENS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    shape = (f"{cfg.vision_tokens} vision tokens of width {cfg.vision_dim}"
             if cfg.family == "vlm" else f"{cfg.enc_layers} encoder layers over "
                                         f"{cfg.enc_seq} frames")
    log(f"[mm] {arch} ({cfg.family}): {cfg.n_layers} layers, d{cfg.d_model}, {shape}, "
        f"{n_params} params ({2 * n_params / 2**30:.2f} GiB as bf16), init "
        f"{time.perf_counter() - t0:.2f} s; smoke model: card == host bytes")
    resp, launches, des_calls, n_out, dt, peak, pf_ms, dec_ms, rows, read_ms = (
        serve_and_step_times(dev, params, cfg, wires))
    out = [launches]
    extra = (f"{cfg.vision_tokens} prefix positions" if cfg.family == "vlm" else
             f"the encoder over {cfg.enc_seq} frames")
    log(f"[mm] {arch} | {card} | serve_requests: {len(wires)} requests, {n_out} tokens in "
        f"{dt:.3f} s: {len(wires) / dt:.3f} req/s, {n_out / dt:.1f} tok/s | prefill step "
        f"({SLOTS}x{PAD_TO} tokens + {extra}) {pf_ms:.3f} ms, decode step ({SLOTS} slots, "
        f"{rows} K/V rows) "
        f"{dec_ms:.3f} ms against a {read_ms:.3f} ms read bound | peak {peak:.2f} GiB | "
        f"launches {launches}; kernel DES == plain "
        f"at the {len(des_calls)} recorded calls")
    diff = modality_reaches_logits(params, cfg, served_batch(cfg, wires, PAD_TO, SLOTS, dev))
    log(f"[mm] {arch} | {card} | one extra prefill of the served {SLOTS}x{PAD_TO} batch "
        f"with seeded non-zero {'vision' if cfg.family == 'vlm' else 'audio'}: logits "
        f"finite, max |seeded - zero placeholder| = {diff:.6f}")

    with pu.recording() as des_calls:
        launches, frame_calls, _ = sharded_run(
            dev, params, cfg, wires, resp, [1 + i % N_SHARDS for i in range(len(wires))],
            f"{arch} round-robin", max_new=FAMILY_MAX_NEW)
    check(launches["unpack_run_aligned"] >= 1 and launches["unpack_gather"] >= 1,
          f"{arch} sharded serve launched no unpack_run_aligned / unpack_gather")
    hold_recorded(des_calls, frame_calls)
    out.append(launches)
    log(f"[mm] {arch} | {card} | serve_requests_sharded ({N_SHARDS} shards, round-robin): "
        f"every response == the batched plane's; frame_batch {launches['frame_batch']}, "
        f"B6 {launches['unpack_frames_batch']} launches == plain at "
        f"{len(frame_calls)} recorded calls")
    if arch in MULTIMODAL_STREAMING:
        with pu.recording() as des_calls:
            launches, frame_calls, result, _ = streaming_run(
                dev, params, cfg, wires, resp, overlap=True, logprobs=True,
                max_new=FAMILY_MAX_NEW)
        hold_recorded(des_calls, frame_calls)
        out.append(launches)
        log(f"[mm] {arch} | {card} | serve_requests_streaming ({N_SHARDS} shards, overlap, "
            f"logprobs): {result['req_s']:.3f} req/s, {result['tok_s']:.1f} tok/s, TTFT "
            f"p50 {result['ttft_p50']:.3f} s p95 {result['ttft_p95']:.3f} s; every wire == "
            f"the batched plane's; chunk_bursts {launches['chunk_bursts']}, frame_batch "
            f"{launches['frame_batch']}, B6 {launches['unpack_frames_batch']} launches == "
            f"plain at {len(frame_calls)} recorded calls")
    del params
    torch.cuda.empty_cache()
    return out


def phase_multimodal(dev, card: str) -> list:
    """Phase 13: phi-3-vision and whisper-tiny served at full width and depth."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = []
    for arch in MULTIMODAL_ARCHS:
        launches += multimodal_run(dev, card, arch)
    log(f"[mm] phase 13: {len(MULTIMODAL_ARCHS)} architectures in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------


def smoke_train_parity(dev) -> str:
    """The float32 smoke model of TRAIN_ARCH takes the same steps on the
    card and on the host, from the same parameters (made on the host) and
    the same wires.  Tolerance: losses ``rtol=1e-5``; parameters ``rtol=1e-4``
    and an ``atol`` of 5 % of the steps' summed rates (AdamW's step is
    normalized, so a grad element near zero passes its relative float32
    noise on to its step whole)."""
    cfg = smoke_config(get_config(TRAIN_ARCH))
    st = SMOKE_TRAIN
    pipe = HGumBatchPipeline(vocab=cfg.vocab, batch=st["batch"], seq=st["seq"], seed=SEED,
                             device="cpu")
    wires = [pipe.host_make_wire() for _ in range(st["steps"])]
    lr_fn = linear_warmup_cosine(st["lr"], st["warmup"], st["steps"])
    runs = {}
    for d in ("cpu", dev):
        params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").to(d)
        opt = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(lr=st["lr"]), lr_fn)
        losses = []
        for w in wires:
            params, opt, m = step(params, opt, decode_batch(w, st["batch"], st["seq"], device=d))
            losses.append(float(m["loss"]))
        runs[str(d)] = (np.array(losses), {n: p.detach().cpu()
                                           for n, p in params.named_parameters()})
    (host_l, host_p), (card_l, card_p) = runs["cpu"], runs[str(dev)]
    atol = 0.05 * sum(float(lr_fn(i)) for i in range(st["steps"]))
    check(np.allclose(card_l, host_l, rtol=1e-5, atol=0),
          f"smoke train: card losses {card_l} != host {host_l}")
    dp = max(float((card_p[n] - host_p[n]).abs().max()) for n in host_p)
    for n in host_p:
        check(torch.allclose(card_p[n], host_p[n], rtol=1e-4, atol=atol),
              f"smoke train: parameter {n} differs on card and host")
    return (f"smoke model ({cfg.n_layers} layers, d{cfg.d_model}, float32, TF32 off): "
            f"{st['steps']} steps of {st['batch']}x{st['seq']}, card == host: losses "
            f"{[round(float(x), 6) for x in card_l]}, max |dloss| "
            f"{np.abs(card_l - host_l).max():.3g}, "
            f"max |dparam| {dp:.3g} (atol {atol:.3g})")


def train_run(dev, card: str) -> dict:
    """TRAIN_ARCH at full width: init on the card, HGumBatchPipeline wires
    through a Prefetcher, decode_batch (B3, two launches a step) and
    make_train_step; TRAIN_STEPS fp32-moment steps, then TRAIN_Q8_STEPS
    with q8 moments.  Returns the launches, the recorded B3 calls and the
    figures."""
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    check(cfg.remat and cfg.remat_policy == "nothing" and cfg.microbatch == 4
          and cfg.dtype == "bfloat16", f"{TRAIN_ARCH}: unexpected training config")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    n_params = param_count(params)
    log(f"[train] {TRAIN_ARCH}: {cfg.n_layers} of {full.n_layers} layers, d{cfg.d_model}, "
        f"{cfg.n_heads} heads, kv {cfg.n_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16, "
        f"{n_params} params, init + fp32 AdamW state {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    fp32_step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR),
                                linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    q8_cfg = AdamWConfig(lr=0.1 * TRAIN_LR, moments="q8")  # the schedule's floor
    pipe = HGumBatchPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED,
                             device=dev)
    real_update = steps_mod.adamw_update
    update_ms = []

    def timed_update(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_update(*a, **k)
        torch.cuda.synchronize()
        update_ms.append(1e3 * (time.perf_counter() - t))
        return out

    rows, peak = [], {}
    pf = Prefetcher(pipe.host_make_wire, depth=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        with mock.patch.object(steps_mod, "adamw_update", timed_update), \
                pu.recording() as des_calls:
            step_fn, moments = fp32_step, "fp32"
            for i in range(TRAIN_STEPS + TRAIN_Q8_STEPS):
                if i == TRAIN_STEPS:
                    peak["fp32"] = torch.cuda.max_memory_allocated() / 2**30
                    del opt
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    opt = adamw_init(params, "q8")
                    step_fn, moments = make_train_step(cfg, q8_cfg), "q8"
                wire = pf.get()
                torch.cuda.synchronize()
                t = time.perf_counter()
                batch = decode_batch(wire, TRAIN_BATCH, TRAIN_SEQ, device=dev)
                torch.cuda.synchronize()
                dec_ms = 1e3 * (time.perf_counter() - t)
                check(pu.LAUNCHES["unpack_gather"] == 2 * (i + 1)
                      and pu.LAUNCHES["unpack_run_aligned"] == 0,
                      f"step {i}: decode_batch made {dict(pu.LAUNCHES)} launches, not two "
                      f"unpack_gather a step")
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                params, opt, m = step_fn(params, opt, batch)
                ev[1].record()
                torch.cuda.synchronize()
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                check(np.isfinite(loss) and np.isfinite(gnorm),
                      f"step {i}: loss {loss} / grad norm {gnorm} not finite")
                rows.append(dict(step=i, moments=moments, loss=loss, gnorm=gnorm,
                                 lr=float(m["lr"]), ms=ev[0].elapsed_time(ev[1]),
                                 decode_ms=dec_ms, update_ms=update_ms[-1]))
                log(f"[train] step {i:2d} ({moments}) loss {loss:.4f} gnorm {gnorm:.4f} lr "
                    f"{rows[-1]['lr']:.3g} | step {rows[-1]['ms']:.1f} ms, decode_batch "
                    f"{dec_ms:.3f} ms, adamw_update {update_ms[-1]:.1f} ms")
    finally:
        pf.close()
    peak["q8"] = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches()
    check(launches["unpack_gather"] == 2 * len(rows), f"B3 launches {launches}")
    # descent: DESCENT_STEPS steps on the last batch, from fresh fp32
    # moments at a constant DESCENT_LR, must lower that batch's loss
    del opt
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=DESCENT_LR))
    with torch.no_grad():
        descent = [float(loss_fn(params, cfg, batch)[0])]
    for _ in range(DESCENT_STEPS):
        params, opt, _ = step_fn(params, opt, batch)
        with torch.no_grad():
            descent.append(float(loss_fn(params, cfg, batch)[0]))
    check(all(np.isfinite(descent)) and descent[-1] < descent[0],
          f"{DESCENT_STEPS} steps on one batch did not lower its loss: {descent}")
    del params, opt, batch
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches, des_calls=des_calls, peak=peak,
                n_params=n_params, cfg=cfg, descent=descent)


def restart_bitwise() -> float:
    """The train CLI on the card, uninterrupted against killed at step 12
    and resumed: the final checkpoints must be equal tensor for tensor, bit
    for bit.  Returns the seconds taken."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")

    def start(*extra):
        return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                                 *RESTART_ARGS, *extra], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)

    def finish(proc):
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)

    with tempfile.TemporaryDirectory() as tmp:
        d1, d2 = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        # the uninterrupted run and the one killed at step 12 side by side
        procs = [start("--ckpt-dir", d1), start("--ckpt-dir", d2, "--die-at", "12")]
        r, r2 = [finish(pr) for pr in procs]
        check(r.returncode == 0 and "done" in r.stdout, f"train CLI failed: {r.stderr[-2000:]}")
        check(r2.returncode == 17, f"--die-at 12 exited {r2.returncode}: {r2.stderr[-2000:]}")
        r = finish(start("--ckpt-dir", d2, "--resume", "auto"))
        check(r.returncode == 0 and "resumed from step 12" in r.stdout,
              f"resume failed: {r.stderr[-2000:]}")
        m1, m2 = CheckpointManager(d1), CheckpointManager(d2)
        check(m1.latest() == m2.latest() == 16, "restart: no step-16 checkpoints")
        (_, t1), (_, t2) = load_checkpoint(m1.path(16)), load_checkpoint(m2.path(16))
        check(set(t1) == set(t2), "restart: checkpoints hold different tensors")
        for k in t1:
            check(t1[k].dtype == t2[k].dtype and np.array_equal(t1[k], t2[k]),
                  f"restart: {k} differs after the resume")
    return time.perf_counter() - t0


#: H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, float32 CUDA cores
BF16_FLOPS, FP32_FLOPS = 989e12, 67e12


def train_step_bound_ms(cfg, n_params: int) -> dict:
    """The least time of one train step of TRAIN_BATCH x TRAIN_SEQ tokens:
    its bf16 matmuls (each layer's forward, its remat recompute and its
    backward, 8 flops a weight a token; the tied unembedding 6) at the
    bf16 peak plus the blocked attention's float32 products (QK and PV
    over every (query, key) pair, as the tiles compute them: forward,
    recompute and a backward of twice the forward) at the float32 peak;
    and ``adamw_update``'s bytes (grads read, fp32 moments and master read
    and written, bf16 parameters written: 30 B a parameter) at the
    memory rate."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    d, hd = cfg.d_model, cfg.hd
    per_layer = d * (2 * cfg.n_heads * hd + 2 * cfg.n_kv * hd) + 3 * d * cfg.d_ff
    head = cfg.padded_vocab * d
    gemm = 8 * per_layer * cfg.n_layers * tokens + 6 * head * tokens
    attn = 4 * (4 * TRAIN_BATCH * TRAIN_SEQ**2 * cfg.n_heads * hd) * cfg.n_layers
    return {"gemm_ms": gemm / BF16_FLOPS * 1e3, "attn_ms": attn / FP32_FLOPS * 1e3,
            "adamw_ms": 30 * n_params / HBM_BYTES_PER_S * 1e3, "gemm": gemm, "attn": attn}


def phase_train(dev, card: str) -> list:
    """Phase 14: the training path (see the module docstring)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[train] {card} | {smoke_train_parity(dev)}")
    res = train_run(dev, card)
    rows, cfg = res["rows"], res["cfg"]
    fp32 = [r for r in rows if r["moments"] == "fp32"]
    steady = [r for r in fp32 if r["step"] >= 2]
    step_ms = statistics.median(r["ms"] for r in steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    calls = [(wire,) + tuple(args) for _, wire, args in res["des_calls"]]
    hold_recorded(res["des_calls"], [])
    b3 = measure("unpack_gather", calls[:2], reps=200)
    b3["library_ms"] = sum(byte_gather_ms(c[0], c[1:], 200) for c in calls[:2])
    log(f"[train] {TRAIN_ARCH} ({cfg.n_layers} of 32 layers, {res['n_params']} params) | {card} | "
        f"{TRAIN_STEPS} fp32 steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens ({cfg.microbatch} "
        f"microbatches, remat '{cfg.remat_policy}'): loss {fp32[0]['loss']:.4f} -> "
        f"{fp32[-1]['loss']:.4f}; step {step_ms:.1f} ms (median of steps 2-"
        f"{TRAIN_STEPS - 1}, CUDA events), {tokens / step_ms * 1e3:.1f} tokens/s | "
        f"decode_batch {statistics.median(r['decode_ms'] for r in steady):.3f} ms, "
        f"adamw_update {statistics.median(r['update_ms'] for r in steady):.1f} ms (medians, "
        f"host clock around synchronized calls) | peak {res['peak']['fp32']:.2f} GiB")
    bound = train_step_bound_ms(cfg, res["n_params"])
    log(f"[train] {TRAIN_ARCH} | {card} | step bound {bound['gemm_ms'] + bound['attn_ms']:.1f} "
        f"ms: bf16 matmuls {bound['gemm']:.4g} flop at 989 TFLOP/s {bound['gemm_ms']:.1f} ms + "
        f"float32 attention {bound['attn']:.4g} flop at 67 TFLOP/s {bound['attn_ms']:.1f} ms; "
        f"step at {(bound['gemm_ms'] + bound['attn_ms']) / step_ms:.1%} of it | adamw_update "
        f"byte bound {bound['adamw_ms']:.1f} ms (30 B a parameter at 3.35 TB/s)")
    q8 = [r for r in rows if r["moments"] == "q8"]
    log(f"[train] {TRAIN_ARCH} | {card} | {len(q8)} q8 steps: loss "
        f"{[round(r['loss'], 4) for r in q8]}, step {statistics.median(r['ms'] for r in q8):.1f} "
        f"ms, adamw_update {statistics.median(r['update_ms'] for r in q8):.1f} ms, peak "
        f"{res['peak']['q8']:.2f} GiB")
    log(f"[train] {TRAIN_ARCH} | {card} | descent: {DESCENT_STEPS} steps at lr {DESCENT_LR:g} on "
        f"the last batch, its loss {[round(x, 4) for x in res['descent']]}")
    log(f"[train] {card} | B3 unpack_gather: {res['launches']['unpack_gather']} launches "
        f"({len(rows)} steps x 2), == plain at the {len(calls)} recorded calls; at one step's "
        f"2 calls ({calls[0][1].numel()} offsets each): kernel {b3['ms']:.4f} ms, bound "
        f"{b3['bound_ms']:.6f} ms ({b3['bytes']} B), plain {b3['plain_ms']:.4f} ms, byte "
        f"gather & mask {b3['library_ms']:.4f} ms")
    dt = restart_bitwise()
    log(f"[train] {card} | train CLI restart on the card (xlstm-125m smoke, 16 steps, "
        f"--die-at 12 then --resume auto): final checkpoints equal bit for bit ({dt:.1f} s)")
    log(f"[train] phase 14: {time.perf_counter() - t0:.1f} s")
    return [res["launches"]]



# ---------------------------------------------------------------------------
# phase 15: the multi-device drivers on one card
# ---------------------------------------------------------------------------


def ring_send(send, payload: torch.Tensor, nbytes: torch.Tensor):
    """One framed send with the launch counts set to 0 before it; returns
    the delivery, the launches and the recorded B5 calls."""
    reset_launches()
    with fp.recording() as rec:
        out = send(payload, nbytes)
        torch.cuda.synchronize()
    return out, read_launches(), rec


def ring_channel(dev, card: str):
    """Phase 15 (a): the framed ring channel; returns the launches of its
    sends and the largest |kernel - plain| at their B5 calls."""
    mesh = Mesh((RING_RANKS,), ("ring",))
    send = make_framed_sender(mesh, "ring", frame_phits=RING_PHITS)
    launches, err = [], 0
    for nbytes_each in (RING_BYTES, RING_LARGE_BYTES):
        rng = np.random.default_rng(nbytes_each)
        host = torch.from_numpy(rng.integers(0, 256, (RING_RANKS, nbytes_each), dtype=np.uint8)
                                .view(np.int32))
        nbytes = torch.full((RING_RANKS,), nbytes_each, dtype=torch.int64)
        (p, nb, ok), counts, rec = ring_send(send, host.to(dev), nbytes.to(dev))
        launches.append(counts)
        check(counts["pack_frames_batch"] == 1 and sum(counts.values()) == 1,
              f"framed send: {counts}, not one B5 join")
        for name, args in rec:
            got, want = fp.pack_frames_batch(*args), fp.pack_frames_batch_plain(*args)
            err = max(err, max_abs_err(got, want))
            check(name == "pack_frames_batch" and same(got, want), "B5 != plain at a send")
        hp, hnb, hok = send(host, nbytes)
        check(all(torch.equal(a.cpu(), b) for a, b in ((p, hp), (nb, hnb), (ok, hok))),
              "framed send: card != host")
        words = nbytes_each // 4
        check(bool(ok.all()) and torch.equal(p[:, :words].cpu(), torch.roll(host, 1, 0)),
              "framed send: member i did not receive member i - 1's payload")
        if nbytes_each == RING_BYTES:  # bench_fabric.py's check_bit_exact_vs_single_hop
            fab = Fabric(n_ranks=RING_RANKS, config=FabricConfig(frame_phits=RING_PHITS),
                         device=dev)
            boxes = [fab.mailbox(r) for r in range(RING_RANKS)]
            wires = [host[r].numpy().tobytes() for r in range(RING_RANKS)]
            for r in range(RING_RANKS):
                boxes[r].send((r + 1) % RING_RANKS, wires[r])
            fab.exchange()
            for r in range(RING_RANKS):
                got = boxes[r].recv()
                check(len(got) == 1 and got[0].ok and got[0].src == (r - 1) % RING_RANKS
                      and got[0].wire == p[r, :words].cpu().numpy().tobytes(),
                      f"fabric one-hop delivery to rank {r} != the framed channel's")
        ms = time_ms(lambda: send(p, nb), reps=20 if nbytes_each == RING_BYTES else 5)
        frame_bytes = 2 * p.numel() * 4  # the payloads read, the frames written: a floor
        log(f"[multi] {card} | framed ring channel, {RING_RANKS} ranks x {nbytes_each} B, "
            f"frame_phits {RING_PHITS}: {ms:.4f} ms a send (CUDA events), "
            f"{counts['pack_frames_batch']} B5 launch a send, card == host"
            + (" == Fabric one-hop" if nbytes_each == RING_BYTES else "")
            + f"; payload bytes x 2 at 3.35 TB/s {frame_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        del p, nb, ok, rec, host
        torch.cuda.empty_cache()
    return launches, err


def pod_grads(params, cfg, batches) -> dict:
    """``{name: (len(batches), ...)}`` float32: each batch's grads of the
    model's loss in one row."""
    stacked = {n: torch.empty((len(batches),) + tuple(p.shape), dtype=torch.float32,
                              device=p.device) for n, p in params.named_parameters()}
    for i, b in enumerate(batches):
        _, grads, _ = microbatched_grads(lambda p, bb: loss_fn(p, cfg, bb), params, b,
                                         cfg.microbatch)
        for n, g in grads.items():
            stacked[n][i].copy_(g)
        del grads
    for p in params.parameters():
        p.requires_grad_(False)
    return stacked


def int8_mean(dev, card: str) -> None:
    """Phase 15 (b): the int8 cross-pod mean at full width."""
    # the smoke model: card == host, bit for bit
    scfg = smoke_config(get_config(TRAIN_ARCH))
    sp = init_params(scfg, torch.Generator().manual_seed(SEED), "cpu")
    pipe = HGumBatchPipeline(vocab=scfg.vocab, batch=4, seq=64, seed=SEED, device="cpu")
    sb = [decode_batch(pipe.host_make_wire(), 4, 64, device="cpu") for _ in range(2)]
    g = pod_grads(sp, scfg, sb)
    host = cross_pod_mean_int8(g, init_error(g))
    card_out = cross_pod_mean_int8({n: t.to(dev) for n, t in g.items()},
                                   {n: torch.zeros_like(t, device=dev) for n, t in g.items()})
    for a, b in zip(host, card_out):
        check(all(torch.equal(a[n], b[n].cpu()) for n in a), "int8 mean: smoke card != host")
    # full width: two 8 x 2048 batches' grads are the two pods
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    n_params = param_count(params)
    pipe = HGumBatchPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED,
                             device=dev)
    batches = [decode_batch(pipe.host_make_wire(), TRAIN_BATCH, TRAIN_SEQ, device=dev)
               for _ in range(2)]
    grads = pod_grads(params, cfg, batches)
    del params, batches
    err = init_error(grads)
    torch.cuda.empty_cache()
    ms = []
    for _ in range(2):  # the first call warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        mean, e_new = cross_pod_mean_int8(grads, err)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        if len(ms) == 1:
            del mean, e_new
    worst_mean = worst_res = 0.0
    for n, gg in grads.items():
        step = float(torch.clamp(gg.abs().amax(), min=1e-12)) / 127
        dm = float((mean[n][0] - gg.mean(dim=0)).abs().max())
        de = float(e_new[n].abs().max())
        check(dm <= step * (1 + 1e-6) and de <= step * (1 + 1e-6),
              f"int8 mean {n}: |mean - fp32 mean| {dm}, |residual| {de}, step {step}")
        worst_mean, worst_res = max(worst_mean, dm / step), max(worst_res, de / step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # grads and error read, the mean and the new error written
    nbytes = (2 * 4 + 2 * 4 + 4 + 2 * 4) * n_params
    log(f"[multi] {card} | cross_pod_mean_int8, pod = 2, {TRAIN_ARCH} {cfg.n_layers} layers "
        f"({n_params} params, {len(grads)} leaves), the float32 grads of two "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} batches: {ms[-1]:.1f} ms (CUDA events), byte bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.1f} ms ({nbytes} B at 3.35 TB/s), peak {peak:.2f} "
        f"GiB; worst |mean - fp32 mean| {worst_mean:.3f} step, worst |residual| "
        f"{worst_res:.3f} step; smoke model card == host")
    del grads, err, mean, e_new
    torch.cuda.empty_cache()


class LayerRunner(torch.nn.Module):
    """One dense attention layer as a module, so ``functional_call`` runs it
    on a slice of the stacked stage parameters."""

    def __init__(self, layer, cfg):
        super().__init__()
        self.layer, self.cfg = layer, cfg

    def forward(self, x):
        return layer_forward(self.layer, x, self.cfg, 0, "attn", "dense", mode="full")[0]


def gpipe(dev, card: str) -> None:
    """Phase 15 (c): GPipe over yi-6b's 8 layers at full width."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    per = cfg.n_layers // PIPE_STAGES
    stacked = stack_stage_params(split_stages(list(params.layers), PIPE_STAGES))
    runner = LayerRunner(params.layers[0], cfg)

    def stage_fn(p, x):
        for i in range(per):
            x = torch.func.functional_call(runner, {f"layer.{n}": t[i] for n, t in p.items()},
                                           (x,))
        return x

    g = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (PIPE_MICRO, PIPE_SEQ), device=dev, generator=g)
    x = params.embed[toks][:, None]  # (n_micro, 1, S, d)
    mesh = Mesh((PIPE_STAGES,), ("stage",))
    stages = [{n: t[s] for n, t in stacked.items()} for s in range(PIPE_STAGES)]
    with torch.no_grad():
        def piped():
            return gpipe_forward(mesh, "stage", stage_fn, stacked, x)

        def sequential():
            out = []
            for m in range(PIPE_MICRO):
                y = x[m]
                for s in range(PIPE_STAGES):
                    y = stage_fn(stages[s], y)
                out.append(y)
            return torch.stack(out)

        def whole():
            y = x.reshape(PIPE_MICRO, PIPE_SEQ, cfg.d_model)
            for lp in params.layers:
                y = layer_forward(lp, y, cfg, 0, "attn", "dense", mode="full")[0]
            return y

        calls = []
        y = gpipe_forward(mesh, "stage", lambda p, a: calls.append(1) or stage_fn(p, a),
                          stacked, x)
        ref = sequential()
        check(torch.equal(y, ref), "gpipe: != the stages applied microbatch by microbatch")
        check(len(calls) == PIPE_MICRO * PIPE_STAGES, f"gpipe: {len(calls)} stage calls")
        w = whole()
        rel = float((y.reshape(w.shape).float() - w.float()).norm() / w.float().norm())
        check(rel <= PIPE_WHOLE_RTOL, f"gpipe vs whole-batch forward: relative {rel}")
        ticks = PIPE_MICRO + PIPE_STAGES - 1
        ms = time_ms(piped, reps=3, warmup=1)
        whole_ms = time_ms(whole, reps=3, warmup=1)
    log(f"[multi] {card} | gpipe_forward, {TRAIN_ARCH} {cfg.n_layers} layers in {PIPE_STAGES} "
        f"stages of {per}, {PIPE_MICRO} microbatches of 1x{PIPE_SEQ}: {ticks} ticks, "
        f"{ms:.1f} ms (CUDA events); == sequential bit for bit; the whole-batch forward "
        f"{whole_ms:.1f} ms, |pipe - whole| / |whole| {rel:.2e} (bound {PIPE_WHOLE_RTOL})")
    del params, stacked, stages, x, y, ref, w
    torch.cuda.empty_cache()


def sharded_steps(dev, card: str) -> None:
    """Phase 15 (d): ``lower_cell``'s steps on the debug mesh against the
    unsharded steps, bit for bit, from the same state."""
    mesh = Mesh(*SHARD_MESH)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS, scan_layers=True)
    pipe = HGumBatchPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED + 1,
                             device=dev)
    batches = [decode_batch(pipe.host_make_wire(), TRAIN_BATCH, TRAIN_SEQ, device=dev)
               for _ in range(2)]
    train_shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    step, _, _ = dryrun.lower_cell(cfg, train_shape, mesh)
    plain = make_train_step(cfg, AdamWConfig(moments=cfg.opt_moments))
    runs = []
    t0 = time.perf_counter()
    with deterministic():
        for fn in (step, plain):
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            opt = adamw_init(params)
            losses = []
            for b in batches:
                params, opt, m = fn(params, opt, b)
                losses.append(m["loss"].clone())
            runs.append((losses, {n: p.detach().clone() for n, p in params.named_parameters()}))
            del params, opt
            torch.cuda.empty_cache()
    (l1, p1), (l2, p2) = runs
    check(all(torch.equal(a, b) for a, b in zip(l1, l2)), f"sharded train losses {l1} != {l2}")
    check(all(torch.equal(p1[n], p2[n]) for n in p1), "sharded train: parameters differ")
    kinds = sorted({k for k, _, _ in step.constrainer.records})
    train_s = time.perf_counter() - t0
    del runs, p1, p2
    # prefill, then decode steps from its cache
    scfg = dataclasses.replace(cfg, scan_layers=False)
    params = init_params(scfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    pstep, _, _ = dryrun.lower_cell(scfg, ShapeConfig("prefill", TRAIN_SEQ, TRAIN_BATCH,
                                                             "prefill"), mesh)
    prompt = {"tokens": batches[0]["tokens"]}
    (t1, c1), (t2, c2) = pstep(params, prompt), make_prefill_step(scfg)(params, prompt)
    check(torch.equal(t1, t2), "sharded prefill: next tokens differ")
    for (n, a), (_, b) in zip(leaf_paths(c1), leaf_paths(c2)):
        check(torch.equal(a, b), f"sharded prefill: cache {n} differs")
    half = {"tokens": batches[1]["tokens"][:, :TRAIN_SEQ // 2]}
    _, cache = make_prefill_step(scfg, cache_len=TRAIN_SEQ)(params, half)
    dstep, _, _ = dryrun.lower_cell(scfg, ShapeConfig("decode", TRAIN_SEQ, TRAIN_BATCH,
                                                             "decode"), mesh)
    ca_, cb_ = cache, tree_map_with_path(lambda _, t: t.clone(), cache)
    ta = tb = batches[1]["tokens"][:, TRAIN_SEQ // 2: TRAIN_SEQ // 2 + 1]
    toks = []
    for _ in range(SHARD_DECODE_STEPS):
        ta, ca_ = dstep(params, ca_, ta)
        tb, cb_ = make_serve_step(scfg)(params, cb_, tb)
        check(torch.equal(ta, tb), "sharded decode: next tokens differ")
        toks.append(ta[:, 0].tolist()[:2])
    for (n, a), (_, b) in zip(leaf_paths(ca_), leaf_paths(cb_)):
        check(torch.equal(a, b), f"sharded decode: cache {n} differs")
    log(f"[multi] {card} | lower_cell on the {SHARD_MESH[0]} {SHARD_MESH[1]} mesh, "
        f"{TRAIN_ARCH} {cfg.n_layers} layers full width: 2 train steps of "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} (losses {[round(float(x), 4) for x in l1]}, "
        f"deterministic algorithms, {train_s:.1f} s for both runs), a prefill of "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} and {SHARD_DECODE_STEPS} decode steps bit for bit the "
        f"unsharded steps'; constrained kinds {kinds}; first tokens {toks}")
    del params, c1, c2, ca_, cb_, cache, batches
    torch.cuda.empty_cache()


def start_dryrun(out_dir: str) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                             TRAIN_ARCH, "--mesh", "both", "--out", out_dir],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)


def finish_dryrun(proc: subprocess.Popen, out_dir: str, card: str) -> None:
    """Phase 15 (e): every supported yi-6b cell ``ok``."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    check(proc.returncode == 0, f"dry run exited {proc.returncode}: {err[-2000:]}")
    total = torch.cuda.get_device_properties(0).total_memory
    check(costanalysis.HBM_BYTES == total,
          f"the dry run's HBM_BYTES {costanalysis.HBM_BYTES} != the card's {total}")
    cells = [json.loads(f.read_text()) for f in sorted(Path(out_dir).glob("*.json"))]
    check(len(cells) == 2 * len(dryrun.SHAPES), f"dry run wrote {len(cells)} cells")
    for c in cells:
        name = f"{c['arch']} {c['shape']} {c['mesh']}"
        if c["status"] == "skipped":
            check(c["shape"] == "long_500k", f"dry run skipped {name}: {c['reason']}")
            log(f"[multi] dry run {name}: skipped ({c['reason']})")
            continue
        check(c["status"] == "ok", f"dry run {name}: {c['status']} {c.get('error')}")
        rf, mem = c["roofline"], c["memory"]
        log(f"[multi] {card} | dry run {name} ({c['n_chips']} ranks): "
            f"{mem['per_device_bytes'] / 2**30:.2f} GiB a device (arguments + outputs - "
            f"aliases), fits {mem['fits']}; t_compute {rf['t_compute'] * 1e3:.3f} ms, "
            f"t_memory {rf['t_memory'] * 1e3:.3f} ms, t_collective "
            f"{rf['t_collective'] * 1e3:.3f} ms (layout), dominant {rf['dominant']}; "
            f"trace {c['trace_s']} s")


def phase_multi(dev, card: str):
    """Phase 15: the multi-device drivers (see the module docstring)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        proc = start_dryrun(out_dir)  # host work, beside the card's checks
        try:
            launches, ring_err = ring_channel(dev, card)
            int8_mean(dev, card)
            gpipe(dev, card)
            sharded_steps(dev, card)
        except BaseException:
            proc.kill()
            proc.communicate()
            raise
        t1 = time.perf_counter()
        finish_dryrun(proc, out_dir, card)
    log(f"[multi] phase 15: {time.perf_counter() - t0:.1f} s (the dry run waited "
        f"{time.perf_counter() - t1:.1f} s after the card's checks)")
    return launches, ring_err


# ---------------------------------------------------------------------------
# phase 16: the README's examples on the card
# ---------------------------------------------------------------------------


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are no package)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def moe_all_to_all(dev, card: str, md):
    """Phase 16's MoE layer at mixtral-8x22b's full width (bf16, seeded on
    the card) over MOE_TOKENS, then its expert lists over the twin's
    8-rank fabric: counted, bit-exact, every RX verdict ok, and each
    recorded ``frame_batch`` and B6 call == plain.  Returns (launches, the
    all-to-all's result)."""
    cfg = get_config(MOE_ARCH)
    check((cfg.d_model, cfg.moe_experts, cfg.moe_topk, cfg.moe_dff or cfg.d_ff) == (
        6144, 8, 2, 16384), f"{MOE_ARCH}'s MoE widths changed")
    g = torch.Generator(device=dev).manual_seed(SEED)
    p = md.init_moe_ffn(cfg, torch.bfloat16, g, dev)
    x = torch.randn((*MOE_TOKENS, cfg.d_model), generator=g, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = md.route(p, x, cfg)
    route_s = time.perf_counter() - t0
    del p, x
    torch.cuda.empty_cache()
    R = min(md.MAX_RANKS, cfg.moe_experts)
    md.expert_all_to_all(r["top"][:1024], cfg.moe_experts, R, dev)  # warm-up
    reset_launches()
    with pu.recording() as des_calls, fp.recording() as frame_calls:
        out = md.expert_all_to_all(r["top"], cfg.moe_experts, R, dev)
    launches = read_launches()
    check(out["bit_exact"] and out["all_ok"] and out["crc_ok"],
          f"{MOE_ARCH} all-to-all: delivery not bit-exact / a verdict not ok")
    got = sum(len(ids) for rank in out["received"] for _, _, ids in rank)
    check(got == r["top"].size, f"{MOE_ARCH} all-to-all delivered {got} of {r['top'].size} ids")
    check(launches["frame_batch"] >= 1 and launches["unpack_frames_batch"] >= 1,
          f"{MOE_ARCH} all-to-all launched no frame_batch / unpack_frames_batch")
    hold_recorded(des_calls, frame_calls)
    log(f"[examples] {card} | {MOE_ARCH} MoE layer (d {cfg.d_model}, {cfg.moe_experts} "
        f"experts top-{cfg.moe_topk}, expert width {cfg.moe_dff or cfg.d_ff}, bf16) over "
        f"{MOE_TOKENS[0]}x{MOE_TOKENS[1]} tokens in {route_s:.3f} s: capacity "
        f"{r['capacity']}, per-expert {r['counts'].tolist()}, moe_dropped {r['dropped']:.6f}, "
        f"moe_balance_loss {r['balance_loss']:.6f} | all-to-all over {out['n_ranks']} ranks: "
        f"{len(out['sent'])} lists, {out['frames_routed']} frames routed, exchange "
        f"{out['exchange_s'] * 1e3:.3f} ms, crc_ok {out['crc_ok']}, bit-exact | launches "
        f"frame_batch {launches['frame_batch']}, B6 {launches['unpack_frames_batch']} == "
        f"plain at {len(frame_calls)} recorded calls")
    return launches, out


def run_examples(runs, tmp: str) -> dict:
    """Each (label, script, arguments) as ``python examples/<script>`` from
    ``repro_torch`` alone, all at once, with ``TMPDIR`` in ``tmp`` (so a
    default checkpoint directory is fresh); each must exit 0.  Returns
    label -> (wall seconds to its exit, output)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), TMPDIR=tmp)
    procs = {}
    t0 = time.perf_counter()
    for label, script, args in runs:
        log_path = Path(tmp) / f"{label.replace(' ', '_')}.log"
        with open(log_path, "w") as f:
            procs[label] = (subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / script), *args], env=env, cwd=tmp,
                stdout=f, stderr=subprocess.STDOUT), log_path)
    walls = {}
    try:
        while len(walls) < len(procs):
            check(time.perf_counter() - t0 < EXAMPLE_TIMEOUT_S,
                  f"examples still running after {EXAMPLE_TIMEOUT_S} s: "
                  f"{sorted(set(procs) - set(walls))}")
            for label, (proc, _) in procs.items():
                if label not in walls and proc.poll() is not None:
                    walls[label] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for label, (proc, log_path) in procs.items():
        text = log_path.read_text()
        check(proc.returncode == 0, f"examples/{label} exited {proc.returncode}:\n"
                                    f"{text[-3000:]}")
        out[label] = (walls[label], text)
    return out


def phase_examples(dev, card: str) -> list:
    """Phase 16: the MoE all-to-all at full width, then the example twins
    as subprocesses (see the module docstring).  Returns the all-to-all's
    launches."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, a2a = moe_all_to_all(dev, card, load_example("torch_moe_dispatch"))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as light_tmp, tempfile.TemporaryDirectory() as full_tmp:
        light = run_examples(EXAMPLE_RUNS, light_tmp)
        full = run_examples([FULL_TRAIN], full_tmp)  # a checkpoint directory of its own
    for label, (wall, text) in {**light, **full}.items():
        last = text.strip().splitlines()[-1]
        log(f"[examples] {label}: exit 0 in {wall:.1f} s; last: {last}")
    check("loopback OK" in light["quickstart"][1]
          and "'unpack_run_aligned'" in light["quickstart"][1],
          "quickstart: the decode launched no B1 on the card")
    check("still byte-identical" in light["serve_requests --sharded --streaming"][1],
          "serve_requests: the streaming plane did not run")
    check("fabric all-to-all bit-exact: True" in light["moe_dispatch"][1],
          "moe_dispatch: the all-to-all was not bit-exact")
    wall, text = full[FULL_TRAIN[0]]
    m = re.search(r"first loss ([\d.]+) -> final ([\d.]+) \((\d+) steps.*?([\d.]+) ms a step",
                  text)
    check(m is not None and float(m[2]) < float(m[1]) and int(m[3]) == FULL_TRAIN_STEPS,
          f"demo-100m: the loss did not fall over {FULL_TRAIN_STEPS} steps:\n{text[-2000:]}")
    log(f"[examples] {card} | walls side by side: "
        + ", ".join(f"{label} {w:.1f} s" for label, (w, _) in light.items())
        + f"; {FULL_TRAIN[0]} alone {wall:.1f} s | all-to-all: {a2a['frames_routed']} frames "
        f"routed, exchange {a2a['exchange_s'] * 1e3:.3f} ms | demo-100m (12 x 768, float32, "
        f"{FULL_TRAIN_STEPS} steps of 8x256): first loss {m[1]}, final loss {m[2]}, "
        f"{m[4]} ms a step (host clock; init and checkpoints included)")
    log(f"[examples] phase 16: {time.perf_counter() - t0:.1f} s")
    return [launches]


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
    fabric_launches, joins = phase_fabric(dev)
    path_launches = [serve_launches, phase_records(rec_plan, rec_lanes, rec_wire, recs),
                     fabric_launches]
    sharded_launches, recorded = phase_sharded(dev, params, cfg, wires, base)
    path_launches += sharded_launches
    streaming_launches, burst_calls, stream_framing, bursts = phase_streaming(
        dev, params, cfg, wires, base)
    path_launches += streaming_launches
    path_launches += phase_telemetry(dev, params, cfg, wires, base, card, sharded_launches[0])
    del params
    torch.cuda.empty_cache()
    rows.update(phase_frame_kernels(dev, recorded, stream_framing, joins))
    ser_launches, ser_rows, padded_calls = phase_device_ser(dev, wires, base, rec_plan,
                                                            rec_lanes, rec_wire, recs, bursts)
    path_launches.append(ser_launches)
    rows.update(ser_rows)
    rows.update(phase_chunk_kernel(dev, padded_calls, burst_calls))
    path_launches += phase_families(dev, card)
    path_launches += phase_multimodal(dev, card)
    path_launches += phase_train(dev, card)
    multi_launches, ring_err = phase_multi(dev, card)
    path_launches += multi_launches
    path_launches += phase_examples(dev, card)
    rows["pack_frames_batch"]["main"]["max_abs_err"] = max(
        rows["pack_frames_batch"]["main"]["max_abs_err"], ring_err)

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
