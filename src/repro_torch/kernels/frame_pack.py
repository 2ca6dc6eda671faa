"""Routed-fabric frame assembly, RX split and stream-fragment assembly on the card.

Three hand-written CUDA kernels (``csrc/frame_pack.cu``), each beside a
plain PyTorch version with the same signature:

* :func:`pack_frames_batch` — join ``(..., 4)`` header rows (size, level,
  CRC32, route) and ``(..., frame_words)`` payload rows into wire-layout
  frames ``(..., 4 + frame_words)``.  Replaces the Pallas body
  ``_assemble_kernel`` of ``repro.kernels.frame_pack``.
* :func:`unpack_frames_batch` — split ``(N, 4 + frame_words)`` delivered
  frames into headers ``(N, 4)`` and payloads ``(N, frame_words)``.
  Replaces ``_split_kernel``.
* :func:`pack_chunks_batch` — one wire row ``[stream_id, step, flags |
  element words | count]`` per stream fragment from meta ``(B, 3)``,
  element words ``(B, capW)`` and counts ``(B, 1)``.  Replaces
  ``_chunk_kernel``; with ``elem_words`` it also zeroes the element words
  past ``count * elem_words``, the tail mask the reference's
  ``kernels.ops.encode_chunks_batch`` applies before its kernel.

The structure half of framing (sizes, CRC32, route words, tail masking) is
``fabric.frames.frame_parts_batch``; these kernels move the words.

Lanes are ``int32`` tensors holding u32 bits.  Dispatch: a wrapper takes
its plain version only for tensors on the CPU.  For CUDA tensors it
launches the kernel or raises; any other device raises.  Each launch adds
one to :data:`LAUNCHES`; inside :func:`recording` it also records the
call's inputs, so a path's calls can be replayed as the path made them.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from . import _build
from .phit_unpack import _stream

HDR_WORDS = 4
#: u32 words of stream-fragment meta: (stream_id, step, flags)
CHUNK_META_WORDS = 3

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "pack_frames_batch": 0,
    "unpack_frames_batch": 0,
    "pack_chunks_batch": 0,
}

_SIGNATURES = {
    "hgum_pack_frames_batch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ],
    "hgum_unpack_frames_batch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ],
    "hgum_pack_chunks_batch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}

#: inside :func:`recording`: (kernel, inputs) of every launch
_RECORDED: Optional[List[Tuple[str, tuple]]] = None

# one launch covers at most 2**31 - 1 blocks of 256 threads
_MAX_WORDS = (2**31 - 1) * 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, tuple]]]:
    """Collect ``(kernel, inputs)`` for every launch inside the block;
    ``wrapper(*inputs)`` repeats the call."""
    global _RECORDED
    outer, _RECORDED = _RECORDED, []
    try:
        yield _RECORDED
    finally:
        _RECORDED = outer


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernels, with every entry point's C signature declared."""
    lib = _build.library("frame_pack")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hgum_frame_pack_error_string.argtypes = [ctypes.c_int]
    lib.hgum_frame_pack_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kernel: str, inputs: tuple, fn: str, *args) -> None:
    """Launch ``fn`` for the wrapper call with ``inputs``."""
    lib = _library()
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.hgum_frame_pack_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")
    LAUNCHES[kernel] += 1
    if _RECORDED is not None:
        _RECORDED.append((kernel, inputs))


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """Validate the operands; True routes to the plain version."""
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"frames are int32 lanes of u32 words, got {t.dtype}")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: the kernels run on CUDA, "
                         f"their plain versions on the CPU")
    return False


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def pack_frames_batch_plain(headers: torch.Tensor, payloads: torch.Tensor) -> torch.Tensor:
    return torch.cat([headers, payloads], dim=-1)


def unpack_frames_batch_plain(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return frames[:, :HDR_WORDS].contiguous(), frames[:, HDR_WORDS:].contiguous()


def pack_chunks_batch_plain(meta: torch.Tensor, tokens: torch.Tensor,
                            counts: torch.Tensor, elem_words: int = 0) -> torch.Tensor:
    """``[meta | tokens | counts]`` rows; ``elem_words > 0`` first zeroes
    the element words at columns ``>= counts * elem_words`` (a u32
    product, as the reference computes it)."""
    if elem_words:
        col = torch.arange(tokens.shape[1], device=tokens.device)
        nwords = ((counts.long() & 0xFFFFFFFF) * elem_words) & 0xFFFFFFFF
        tokens = torch.where(col[None, :] < nwords, tokens, 0)
    return torch.cat([meta, tokens, counts], dim=-1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def pack_frames_batch(headers: torch.Tensor, payloads: torch.Tensor) -> torch.Tensor:
    """Frames ``(..., 4 + frame_words)`` from headers ``(..., 4)`` and
    payloads ``(..., frame_words)`` with the same leading shape (the
    reference takes ``(B, F, ·)``)."""
    if headers.shape[-1] != HDR_WORDS or headers.shape[:-1] != payloads.shape[:-1]:
        raise ValueError(f"headers {tuple(headers.shape)} and payloads "
                         f"{tuple(payloads.shape)} do not pair up as (..., 4) and "
                         f"(..., frame_words)")
    if _on_cpu(headers, payloads):
        return pack_frames_batch_plain(headers, payloads)
    frame_words = payloads.shape[-1]
    rows = headers.numel() // HDR_WORDS
    if rows * (HDR_WORDS + frame_words) > _MAX_WORDS:
        raise ValueError(f"{rows} frames of {frame_words} words exceed one launch")
    headers, payloads = headers.contiguous(), payloads.contiguous()
    out = torch.empty(headers.shape[:-1] + (HDR_WORDS + frame_words,),
                      dtype=torch.int32, device=headers.device)
    if rows:
        _launch("pack_frames_batch", (headers, payloads), "hgum_pack_frames_batch",
                headers.data_ptr(), payloads.data_ptr(), out.data_ptr(), rows,
                frame_words, _stream(out))
    return out


def unpack_frames_batch(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``(N, 4 + frame_words)`` frames into (headers ``(N, 4)``,
    payloads ``(N, frame_words)``)."""
    if frames.dim() != 2 or frames.shape[1] < HDR_WORDS:
        raise ValueError(f"frames must be (N, 4 + frame_words), got {tuple(frames.shape)}")
    if _on_cpu(frames):
        return unpack_frames_batch_plain(frames)
    rows, width = frames.shape
    if rows * width > _MAX_WORDS:
        raise ValueError(f"{rows} frames of {width} words exceed one launch")
    frames = frames.contiguous()
    hdr = torch.empty((rows, HDR_WORDS), dtype=torch.int32, device=frames.device)
    pay = torch.empty((rows, width - HDR_WORDS), dtype=torch.int32, device=frames.device)
    if rows:
        _launch("unpack_frames_batch", (frames,), "hgum_unpack_frames_batch",
                frames.data_ptr(), hdr.data_ptr(), pay.data_ptr(), rows,
                width - HDR_WORDS, _stream(frames))
    return hdr, pay


def pack_chunks_batch(meta: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor,
                      elem_words: int = 0) -> torch.Tensor:
    """Fragment rows ``(B, capW + 4)`` from meta ``(B, 3)``, element words
    ``(B, capW)`` and element counts ``(B, 1)``: ``[stream_id, step, flags |
    capW words | count]``, the count after the elements (paper §IV-B).

    With the default ``elem_words=0`` the element words are copied as they
    are (the reference kernel's contract: pre-masked tokens); with
    ``elem_words >= 1`` the words past ``count * elem_words`` come out as
    zeros, the fused tail mask of ``ops.encode_chunks_batch``."""
    if (meta.dim() != 2 or meta.shape[1] != CHUNK_META_WORDS or tokens.dim() != 2
            or tuple(counts.shape) != (meta.shape[0], 1)
            or tokens.shape[0] != meta.shape[0]):
        raise ValueError(f"meta {tuple(meta.shape)}, tokens {tuple(tokens.shape)} and "
                         f"counts {tuple(counts.shape)} do not pair up as (B, 3), "
                         f"(B, capW) and (B, 1)")
    if not 0 <= elem_words < 2**31:
        raise ValueError(f"elem_words must be >= 0 (0: no tail mask), got {elem_words}")
    if _on_cpu(meta, tokens, counts):
        return pack_chunks_batch_plain(meta, tokens, counts, elem_words)
    rows, cap_w = tokens.shape
    width = cap_w + CHUNK_META_WORDS + 1
    if rows * width > _MAX_WORDS:
        raise ValueError(f"{rows} fragments of {width} words exceed one launch")
    meta, tokens, counts = meta.contiguous(), tokens.contiguous(), counts.contiguous()
    out = torch.empty((rows, width), dtype=torch.int32, device=meta.device)
    if rows:
        _launch("pack_chunks_batch", (meta, tokens, counts, elem_words),
                "hgum_pack_chunks_batch", meta.data_ptr(), tokens.data_ptr(),
                counts.data_ptr(), out.data_ptr(), rows, cap_w, elem_words, _stream(out))
    return out
