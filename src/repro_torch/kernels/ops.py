"""Public wrappers around the port's kernels (``phit_unpack``, ``frame_pack``).

``decode_batch_kernel`` is the production DES payload pass of the serving
plane: it takes the flat u32 lanes of a batch of wires plus the structure
pass's ``BatchedDecodePlan`` and makes ONE kernel launch per leaf path —
the uniform-run kernel where the leaf is one run across the whole batch,
the gather kernel otherwise (ragged containers).  It is the counterpart of
``repro.kernels.ops.decode_batch_kernel``, and its output equals
``core.vectorized.decode_batch`` on every row that lies inside its wire.

``encode_frames_batch`` / ``decode_frames_batch`` are the routed fabric's
batched SER and RX split (counterparts of the reference functions of the
same names): the frame structure pass of ``fabric.frames`` plus one
``pack_frames_batch`` launch, and one ``unpack_frames_batch`` launch.

Tensors on a CUDA device launch the CUDA kernels; tensors on the CPU take
the kernels' plain versions.  Lanes are ``int32`` tensors holding u32 bits.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.vectorized import BatchedDecodePlan, DecodePlan, stack_wires
from ..device import DeviceLike, default_device
from .frame_pack import pack_chunks_batch, pack_frames_batch, unpack_frames_batch
from .phit_unpack import unpack_gather, unpack_run


def wire_to_u32(wire: bytes | np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """bytes -> little-endian u32 lanes (tail zero-padded), int32 carrier."""
    buf = np.frombuffer(wire, np.uint8) if isinstance(wire, bytes) else np.asarray(wire, np.uint8)
    pad = (-len(buf)) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    return torch.from_numpy(buf.view(np.int32).copy()).to(default_device(device))


def decode_run(wire_u32: torch.Tensor, base: int, stride: int, count: int,
               nbytes: int) -> torch.Tensor:
    return unpack_run(wire_u32, base, stride, count, nbytes)


def decode_gather(wire_u32: torch.Tensor, offsets, nbytes: int) -> torch.Tensor:
    """Gather rows at byte ``offsets`` (numpy or tensor; int64 on the card)."""
    offs = torch.as_tensor(offsets, dtype=torch.int64, device=wire_u32.device)
    return unpack_gather(wire_u32, offs.contiguous(), nbytes)


# ---------------------------------------------------------------------------
# Plan-driven decode: choose run-kernel vs gather-kernel per leaf
# ---------------------------------------------------------------------------


def runs_from_plan(plan: DecodePlan, path: str) -> Optional[Tuple[int, int]]:
    """If `path`'s instances form one uniform run, return (base, stride)."""
    n = plan.counts[path]
    if n == 0:
        return None
    offs = np.asarray(plan.offsets[path][:n])
    if n == 1:
        return int(offs[0]), max(plan.nbytes[path], 4)
    strides = np.diff(offs)
    if np.all(strides == strides[0]) and strides[0] > 0:
        return int(offs[0]), int(strides[0])
    return None


def wires_to_u32(wires: List[bytes], device: DeviceLike = None) -> Tuple[torch.Tensor, int]:
    """Stack N wires into one flat u32 lane buffer.

    Rows are padded to a common 4-byte-aligned length L so per-message byte
    offsets become flat offsets by adding ``m * L``.  Returns (lanes, L).
    """
    L = -(-max([len(w) for w in wires] + [1]) // 4) * 4
    mat = stack_wires(wires, pad_to=L)
    lanes = torch.from_numpy(mat.reshape(-1).view(np.int32))
    return lanes.to(default_device(device)), L


def batched_runs_from_plan(
    bplan: BatchedDecodePlan, path: str, row_bytes: int
) -> Optional[Tuple[int, int]]:
    """If `path` is one uniform run in EVERY message at the same (base,
    stride) relative to its row, the flat batch is itself a uniform run of
    ``N * cap`` instances (stride between rows = row_bytes).  This is the
    fixed-layout fast path (e.g. batch_schema rows): one ``unpack_run``
    covers the whole serving batch."""
    n = bplan.counts[path]
    cap = bplan.cap(path)
    if not np.all(n == cap) or cap == 0:
        return None  # ragged: padding rows would break the run
    offs = np.asarray(bplan.offsets[path])
    if cap == 1:
        # one instance per row: consecutive flat instances sit exactly one
        # row apart, so the row itself is the stride
        stride = row_bytes
    else:
        strides = np.diff(offs, axis=1)
        if not (np.all(strides == strides[0, 0]) and strides[0, 0] > 0):
            return None
        stride = int(strides[0, 0])
    if not np.all(offs[:, 0] == offs[0, 0]):
        return None
    # flat offset of (msg m, inst k) is base + m*row_bytes + k*stride; this
    # equals base + (m*cap + k)*stride — one big run — iff cap*stride tiles
    # the row exactly.
    if cap * stride != row_bytes:
        return None
    return int(offs[0, 0]), stride


def decode_batch_kernel(
    wires_u32: torch.Tensor,  # flat lanes from wires_to_u32
    row_bytes: int,
    bplan: BatchedDecodePlan,
    paths: Optional[List[str]] = None,
) -> Dict[str, torch.Tensor]:
    """Batched DES payload pass on the kernels.

    ONE ``unpack_run``/``unpack_gather`` launch per leaf path decodes that
    leaf for every message in the batch (the kernel twin of
    ``core.vectorized.decode_batch``).  Flat byte offsets are int64.
    Returns path -> int32 lanes [N, cap, nlanes].
    """
    N = bplan.n_messages
    base = (np.arange(N, dtype=np.int64) * row_bytes)[:, None]
    out = {}
    for p in paths or bplan.offsets.keys():
        nbytes = bplan.nbytes[p]
        cap = bplan.cap(p)
        run = batched_runs_from_plan(bplan, p, row_bytes)
        if run is not None:
            b, stride = run
            lanes = decode_run(wires_u32, b, stride, N * cap, nbytes)
        else:
            lanes = decode_gather(wires_u32, (bplan.offsets[p] + base).reshape(-1), nbytes)
        out[p] = lanes.reshape(N, cap, lanes.shape[-1])
    return out


def decode_message_kernel(
    wire_u32: torch.Tensor,
    plan: DecodePlan,
    paths: Optional[List[str]] = None,
) -> Dict[str, torch.Tensor]:
    """DES payload pass of one message on the kernels (run fast path per
    leaf).  Returns path -> int32 lanes [cap, nlanes]."""
    out = {}
    for p in paths or plan.offsets.keys():
        nbytes = plan.nbytes[p]
        run = runs_from_plan(plan, p)
        if run is not None:
            base, stride = run
            got = decode_run(wire_u32, base, stride, plan.counts[p], nbytes)
            cap = plan.cap(p)
            if got.shape[0] < cap:
                got = torch.nn.functional.pad(got, (0, 0, 0, cap - got.shape[0]))
            out[p] = got
        else:
            out[p] = decode_gather(wire_u32, plan.offsets[p], nbytes)
    return out


# ---------------------------------------------------------------------------
# Routed-fabric SER / RX split
# ---------------------------------------------------------------------------


def encode_frames_batch(
    payloads_u32: torch.Tensor,  # (B, Wcap) int32 lanes, one row per send
    nbytes,  # (B,) true byte lengths
    routes,  # (B, 3) (src, dst, seq0) per stream
    list_level=1,  # int, or (B,) per-stream ListLevels
    frame_phits: int = 16,
    adaptive: bool = False,  # stamp the shortest-path route-word bit
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-destination SER: B wires -> B routed framed streams.

    One vectorised structure pass (sizes, CRC32, route words) plus one
    ``pack_frames_batch`` launch.  Returns (frames (B, F, width) int32
    lanes, n_frames (B,))."""
    from ..fabric.frames import frame_parts_batch

    hdr, data, n_frames = frame_parts_batch(
        payloads_u32, nbytes, routes, list_level=list_level,
        frame_phits=frame_phits, adaptive=adaptive,
    )
    return pack_frames_batch(hdr, data), n_frames


def decode_frames_batch(frames_u32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RX split of delivered frames: (N, width) -> (headers, payloads)."""
    return unpack_frames_batch(frames_u32)


def encode_chunks_batch(
    meta: torch.Tensor,  # (B, 3) int32 lanes — (stream_id, step, flags)
    tokens: torch.Tensor,  # (B, cap * elem_words) int32 element words
    counts: torch.Tensor,  # (B,) int32 lanes — true ELEMENT counts
    elem_words: int = 1,
) -> torch.Tensor:
    """Generated stream-fragment SER: B fragments -> B wire rows
    ``[meta | element words | count]`` (count after the elements, §IV-B).

    The counterpart of ``repro.kernels.ops.encode_chunks_batch``: element
    words past each fragment's ``count * elem_words`` come out as zeros
    and the trailing word is the element count.  The reference masks with
    a ``jnp.where`` and then runs its kernel; here the mask is part of the
    one ``pack_chunks_batch`` launch.  Returns ``(B, capW + 4)`` int32
    lanes on the inputs' device."""
    if elem_words < 1:
        raise ValueError(f"elem_words must be >= 1, got {elem_words}")
    if counts.dim() != 1:
        raise ValueError(f"counts must be (B,), got {tuple(counts.shape)}")
    return pack_chunks_batch(meta, tokens, counts[:, None], elem_words)
