"""SER payload run, header stamping, routed-fabric frame assembly, RX split
and stream-fragment assembly on the card.

Hand-written CUDA kernels (``csrc/frame_pack.cu``), each beside a plain
PyTorch version with the same signature:

* :func:`pack_run` — ``(N, nlanes)`` token lanes, lane-masked to ``nbytes``
  and zero-padded to a pitch of ``stride`` bytes (``stride % 4 == 0``),
  flattened into the wire ``(N * stride / 4,)``.  The SER mirror of
  ``phit_unpack.unpack_run_aligned``; replaces the Pallas body
  ``_pack_kernel_aligned`` of ``repro.kernels.frame_pack``.
* :func:`stamp_headers` — a copy of a ``(W,)`` wire with each ``(H, 3)``
  header row ``[word, size, list_level]`` written into words ``word`` and
  ``word + 1``, in order, so the last header wins where two meet; words
  outside ``[0, W)`` are dropped (the reference's numpy oracle wraps a
  negative word and raises past the end).  Replaces ``_header_kernel``;
  one cooperative launch per call.
* :func:`frame_batch` — the routed fabric's framing in one launch: B
  streams of payload words, their byte counts, routes ``(src, dst, seq0)``
  and ListLevels -> the wire-layout frames ``(B, F, 4 + frame_words)``,
  headers (size, level, CRC32, route) built in the kernel.  Replaces the
  Pallas body ``_assemble_kernel`` together with the structure pass that
  feeds it in the reference (``fabric/frames.py``'s
  ``frame_parts_batch``); its plain version is that structure pass
  (``framing.frame_parts_batch``) followed by the join.
* :func:`pack_frames_batch` — join ``(..., 4)`` header rows (size, level,
  CRC32, route) and ``(..., frame_words)`` payload rows into wire-layout
  frames ``(..., 4 + frame_words)``, the Pallas ``_assemble_kernel``'s own
  function; the same kernel body as :func:`frame_batch` with the header
  build compiled out.  On the card a frame is whole 16-byte phits
  (``frame_words % 4 == 0``).
* :func:`unpack_frames_batch` — split ``(N, 4 + frame_words)`` delivered
  frames into headers ``(N, 4)`` and payloads ``(N, frame_words)``.
  Replaces ``_split_kernel``; one launch moves whole 16-byte phits (fabric
  frames) or, for other widths and unaligned views, single words, into
  two contiguous views of one buffer.
* :func:`pack_chunks_batch` — one wire row ``[stream_id, step, flags |
  element words | count]`` per stream fragment from meta ``(B, 3)``,
  element words ``(B, capW)`` and counts ``(B, 1)``.  Replaces
  ``_chunk_kernel``; with ``elem_words`` it also zeroes the element words
  past ``count * elem_words``, the tail mask the reference's
  ``kernels.ops.encode_chunks_batch`` applies before its kernel.
* :func:`chunk_bursts` — the same kernel body in its trimmed form: every
  row written as exactly ``[meta | count * elem_words words | count]`` at
  a word offset of one flat output, ``elem_words`` given per row, so the
  fragments of several lanes (token and logprob plans) pack in one launch
  and their bursts are slices of the result.

The structure half of framing (sizes, CRC32, route words, tail masking) in
plain torch is ``framing.frame_parts_batch``: with the join, the plain
version of :func:`frame_batch` and the reference its kernel is held to.

Lanes are ``int32`` tensors holding u32 bits.  Dispatch: a wrapper takes
its plain version only for tensors on the CPU.  For CUDA tensors it
launches the kernel or raises; any other device raises.  Each launch adds
one to :data:`LAUNCHES`; inside :func:`recording` it also records the
call's inputs, so a path's calls can be replayed as the path made them.

The reference's wrappers keep its signatures, the keyword-only
``interpret`` (and ``block``) of the Pallas grid included.  That grid
does not exist on the card, so both are accepted and ignored: the
tensors' device alone picks the route.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.vectorized import lanes_to_i64, u32_to_lanes
from . import _build
from .framing import CRC_TABLES, frame_parts_batch
from .phit_unpack import _lane_mask, _stream

HDR_WORDS = 4
#: u32 words of stream-fragment meta: (stream_id, step, flags)
CHUNK_META_WORDS = 3

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "pack_run": 0,
    "stamp_headers": 0,
    "pack_frames_batch": 0,
    "frame_batch": 0,
    "unpack_frames_batch": 0,
    "pack_chunks_batch": 0,
    "chunk_bursts": 0,
}

# CRC lanes per frame of the frame_batch kernel (kCrcLanes in
# csrc/frame_pack.cu): the shift tables are made for it
_CRC_LANES = 4

_SIGNATURES = {
    "hgum_pack_run": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ],
    "hgum_stamp_headers": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ],
    "hgum_pack_frames_batch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ],
    "hgum_frame_batch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
    ],
    "hgum_unpack_frames_batch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ],
    "hgum_pack_chunks_batch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "hgum_chunk_bursts": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ],
}

#: inside :func:`recording`: (kernel, inputs) of every launch
_RECORDED: Optional[List[Tuple[str, tuple]]] = None

# one launch covers at most 2**31 - 1 blocks of 256 threads
_MAX_WORDS = (2**31 - 1) * 256
# the frame kernel's index math is 32-bit: frames, and words of a payload row;
# so is the fragment kernel's: rows, and words of a row
_MAX_FRAMES = 2**32 - 1


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
    """Validate the operands, cheapest test first; True routes to the plain
    version."""
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"operands are int32 lanes of u32 words, got {t.dtype}")
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            devs = {str(x.device) for x in tensors}
            raise ValueError(f"operands on different devices: {sorted(devs)}")
    if dev.type == "cuda":
        return False
    if dev.type == "cpu":
        return True
    raise ValueError(f"unsupported device {dev}: the kernels run on CUDA, "
                     f"their plain versions on the CPU")


def _shift_table(n_bytes: int, crc: np.ndarray) -> np.ndarray:
    """(1024,) uint32: entry ``256 j + b`` is the zero-initialised CRC
    register ``b << 8 j`` after ``n_bytes`` zero bytes.  The shift is linear,
    so it is four lookups of this table for any register."""
    t0 = crc[0].astype(np.uint32)
    v = (np.arange(256, dtype=np.uint32)[None, :]
         << (8 * np.arange(4, dtype=np.uint32))[:, None]).reshape(-1)
    for _ in range(n_bytes):
        v = t0[v & 0xFF] ^ (v >> 8)
    return v


def _shift_by(table: np.ndarray, v: np.ndarray) -> np.ndarray:
    return (table[v & 0xFF] ^ table[256 + ((v >> 8) & 0xFF)]
            ^ table[512 + ((v >> 16) & 0xFF)] ^ table[768 + (v >> 24)])


def crc_tables(frame_phits: int) -> Tuple[np.ndarray, int]:
    """What the frame_batch kernel reads besides the frames: the CRC-32
    slicing-by-4 tables (in ``framing``'s order: T3 for byte 0 ... T0 for
    byte 3), then two shift tables for its 4 CRC lanes per frame, step
    ``k`` shifting by ``16 S 2**k`` bytes with ``S = ceil((1 + frame_phits)
    / 4)`` the phits each lane takes; and ``crc_xor``, the
    zero-initialised CRC of a frame's message to zlib's CRC (``shift(~0,
    message bytes) ^ ~0``)."""
    crc = CRC_TABLES
    blob = [np.ascontiguousarray(crc[::-1].reshape(-1), dtype=np.uint32)]
    shift = _shift_table(-(-(1 + frame_phits) // _CRC_LANES) * 16, crc)
    for _ in range(_CRC_LANES.bit_length() - 1):
        blob.append(shift)
        shift = _shift_by(shift, shift)  # twice the length
    reg = 0xFFFFFFFF
    for _ in range(4 * (3 + 4 * frame_phits)):  # the message's bytes
        reg = int(crc[0][reg & 0xFF]) ^ (reg >> 8)
    return np.concatenate(blob), reg ^ 0xFFFFFFFF


@functools.cache
def _crc_tables_on(device: torch.device, frame_phits: int) -> Tuple[torch.Tensor, int]:
    blob, crc_xor = crc_tables(frame_phits)
    return torch.from_numpy(blob.view(np.int32)).to(device), crc_xor


def _check_pack_run(tokens: torch.Tensor, stride: int, nbytes: int) -> Tuple[int, int]:
    """Raise where the reference ``pack_run`` raises or asserts; returns
    (rows, lanes)."""
    if tokens.dim() != 2:
        raise ValueError(f"tokens must be (N, nlanes), got {tuple(tokens.shape)}")
    n, nlanes = tokens.shape
    if stride % 4 != 0:
        raise ValueError(f"pack_run: stride must be 4-byte aligned, got {stride}")
    if nbytes < 1 or nlanes != (nbytes + 3) // 4:
        raise ValueError(f"pack_run: {nlanes} lanes do not hold {nbytes} bytes "
                         f"(need ceil(nbytes / 4))")
    if stride < 4 * nlanes:
        raise ValueError(f"pack_run: stride {stride} is shorter than {nlanes} lanes")
    return n, nlanes


def _check_chunks(meta: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor) -> None:
    if (meta.dim() != 2 or meta.shape[1] != CHUNK_META_WORDS or tokens.dim() != 2
            or tuple(counts.shape) != (meta.shape[0], 1)
            or tokens.shape[0] != meta.shape[0]):
        raise ValueError(f"meta {tuple(meta.shape)}, tokens {tuple(tokens.shape)} and "
                         f"counts {tuple(counts.shape)} do not pair up as (B, 3), "
                         f"(B, capW) and (B, 1)")


def _check_chunk_bursts(meta: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor,
                        elem_words: torch.Tensor, offsets: torch.Tensor) -> None:
    _check_chunks(meta, tokens, counts)
    rows = meta.shape[0]
    if tuple(elem_words.shape) != (rows, 1) or tuple(offsets.shape) != (rows,):
        raise ValueError(f"elem_words {tuple(elem_words.shape)} and offsets "
                         f"{tuple(offsets.shape)} are not (B, 1) and (B,) for {rows} rows")
    if offsets.dtype != torch.int64 or offsets.device != meta.device:
        raise ValueError(f"offsets must be int64 on {meta.device}, got {offsets.dtype} on "
                         f"{offsets.device}")


def _check_stamp_headers(wire: torch.Tensor, headers: torch.Tensor) -> None:
    if wire.dim() != 1 or headers.dim() != 2 or headers.shape[1] != 3:
        raise ValueError(f"wire {tuple(wire.shape)} and headers {tuple(headers.shape)} "
                         f"are not (W,) and (H, 3)")


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def pack_run_plain(tokens: torch.Tensor, stride: int, nbytes: int) -> torch.Tensor:
    _, nlanes = _check_pack_run(tokens, stride, nbytes)
    masked = u32_to_lanes(lanes_to_i64(tokens) & _lane_mask(nbytes, nlanes, tokens.device))
    return torch.nn.functional.pad(masked, (0, stride // 4 - nlanes)).reshape(-1)


def stamp_headers_plain(wire: torch.Tensor, headers: torch.Tensor) -> torch.Tensor:
    """The serial stamp, vectorised: each slot takes the value of the last
    header that writes it (the highest header index, found with an
    ``amax`` scatter); slots outside the wire go to a trash word."""
    _check_stamp_headers(wire, headers)
    n_words, dev = wire.shape[0], wire.device
    word = headers[:, 0].long()
    slots = torch.cat([word, word + 1])
    slots = torch.where((slots >= 0) & (slots < n_words), slots, n_words)
    order = torch.arange(headers.shape[0], device=dev).repeat(2)
    owner = torch.full((n_words + 1,), -1, dtype=torch.int64, device=dev)
    owner.scatter_reduce_(0, slots, order, "amax")
    slots = torch.where(owner[slots] == order, slots, n_words)
    out = torch.cat([wire, wire.new_zeros(1)])
    out.scatter_(0, slots, torch.cat([headers[:, 1], headers[:, 2]]))
    return out[:n_words]


def pack_frames_batch_plain(headers: torch.Tensor, payloads: torch.Tensor) -> torch.Tensor:
    return torch.cat([headers, payloads], dim=-1)


def frame_batch_plain(payloads: torch.Tensor, nbytes, routes, levels, frame_phits: int,
                      adaptive: bool = False) -> torch.Tensor:
    """The structure pass (``framing.frame_parts_batch``: sizes, CRC32,
    route words, tail mask) followed by the join."""
    hdr, data, _ = frame_parts_batch(payloads, nbytes, routes, list_level=levels,
                                     frame_phits=frame_phits, adaptive=adaptive)
    return pack_frames_batch_plain(hdr, data)


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


def chunk_bursts_plain(meta: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor,
                       elem_words: torch.Tensor, offsets: torch.Tensor,
                       n_words: int) -> torch.Tensor:
    """The padded rows of :func:`pack_chunks_batch_plain`, each masked with
    its own ``elem_words``, trimmed to ``[meta | live words | count]`` and
    joined in row order; raises unless ``offsets`` is that join's row
    starts and ``n_words`` its length."""
    _check_chunk_bursts(meta, tokens, counts, elem_words, offsets)
    cap_w = tokens.shape[1]
    # the live words: the u32 product counts * elem_words, at most cap_w
    live = (((counts.long() & 0xFFFFFFFF) * (elem_words.long() & 0xFFFFFFFF))
            & 0xFFFFFFFF).clamp(max=cap_w)
    col = torch.arange(cap_w + CHUNK_META_WORDS + 1, device=tokens.device)
    rows = torch.cat([meta, torch.where(col[None, :cap_w] < live, tokens, 0), counts], -1)
    lengths = live[:, 0] + CHUNK_META_WORDS + 1
    starts = torch.cumsum(lengths, 0) - lengths
    if not torch.equal(offsets, starts) or int(lengths.sum()) != int(n_words):
        raise ValueError("offsets and n_words are not the prefix sum of the trimmed rows' "
                         "lengths (4 + counts * elem_words words each)")
    keep = (col[None, :] < CHUNK_META_WORDS + live) | (col[None, :] == cap_w + CHUNK_META_WORDS)
    return rows[keep]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def pack_run(tokens: torch.Tensor, stride: int, nbytes: int, *,
             interpret: bool = True) -> torch.Tensor:
    """The wire ``(N * stride / 4,)`` of ``N`` tokens at a pitch of
    ``stride`` bytes from byte 0: row ``r``, word ``c`` holds ``tokens[r, c]``
    with the bytes past ``nbytes`` zeroed for ``c < nlanes``, and 0 after.
    ``interpret`` (the reference's Pallas switch) is accepted and ignored."""
    stride, nbytes = int(stride), int(nbytes)
    n, nlanes = _check_pack_run(tokens, stride, nbytes)
    if _on_cpu(tokens):
        return pack_run_plain(tokens, stride, nbytes)
    stride_w = stride // 4
    if n * stride_w > _MAX_WORDS:
        raise ValueError(f"{n} tokens at a pitch of {stride} bytes exceed one launch")
    tokens = tokens.contiguous()
    out = torch.empty(n * stride_w, dtype=torch.int32, device=tokens.device)
    if n:
        _launch("pack_run", (tokens, stride, nbytes), "hgum_pack_run", tokens.data_ptr(),
                out.data_ptr(), n, nlanes, stride_w, nbytes, _stream(out))
    return out


def stamp_headers(wire_u32: torch.Tensor, headers: torch.Tensor, *,
                  interpret: bool = True) -> torch.Tensor:
    """A copy of the ``(W,)`` wire with ``size`` at word ``word`` and
    ``list_level`` at ``word + 1`` for each header row ``[word, size,
    list_level]`` of ``(H, 3)``, in order (the last header wins where two
    meet); words outside the wire are dropped.  One launch on the card (none
    for ``W = 0``); a table whose words increase by at least 2 skips the
    owner pass, whose scratch comes from the caching allocator,
    uninitialised.  ``interpret`` is accepted and ignored."""
    wire = wire_u32
    _check_stamp_headers(wire, headers)
    if _on_cpu(wire, headers):
        return stamp_headers_plain(wire, headers)
    n_words, n_headers = wire.shape[0], headers.shape[0]
    if max(n_words, 2 * n_headers) > _MAX_WORDS or n_headers >= 2**31:
        raise ValueError(f"{n_words} words and {n_headers} headers exceed one launch")
    wire, headers = wire.contiguous(), headers.contiguous()
    out = torch.empty_like(wire)
    if n_words:
        # the owner scratch and, last, the kernel's flag word: none initialised
        owner = torch.empty(n_words + 1, dtype=torch.int32, device=wire.device)
        _launch("stamp_headers", (wire, headers), "hgum_stamp_headers", wire.data_ptr(),
                headers.data_ptr(), owner.data_ptr(), out.data_ptr(), n_words, n_headers,
                _stream(out))
    return out


def pack_frames_batch(headers: torch.Tensor, payloads: torch.Tensor, *,
                      interpret: bool = True) -> torch.Tensor:
    """Frames ``(..., 4 + frame_words)`` from headers ``(..., 4)`` and
    payloads ``(..., frame_words)`` with the same leading shape (the
    reference takes ``(B, F, ·)``); on the card ``frame_words % 4 == 0``.
    ``interpret`` is accepted and ignored."""
    if headers.shape[-1] != HDR_WORDS or headers.shape[:-1] != payloads.shape[:-1]:
        raise ValueError(f"headers {tuple(headers.shape)} and payloads "
                         f"{tuple(payloads.shape)} do not pair up as (..., 4) and "
                         f"(..., frame_words)")
    if _on_cpu(headers, payloads):
        return pack_frames_batch_plain(headers, payloads)
    frame_words = payloads.shape[-1]
    rows = headers.numel() // HDR_WORDS
    if frame_words % 4:
        raise ValueError(f"frames of {frame_words} payload words are not whole 16-byte "
                         f"phits: the card's kernel needs frame_words % 4 == 0")
    if rows > _MAX_FRAMES:
        raise ValueError(f"{rows} frames exceed one launch")
    headers, payloads = headers.contiguous(), payloads.contiguous()
    out = torch.empty(headers.shape[:-1] + (HDR_WORDS + frame_words,),
                      dtype=torch.int32, device=headers.device)
    if rows:
        _launch("pack_frames_batch", (headers, payloads), "hgum_pack_frames_batch",
                headers.data_ptr(), payloads.data_ptr(), out.data_ptr(), rows,
                frame_words, _stream(out))
    return out


def frame_batch(payloads: torch.Tensor, nbytes, routes, levels, frame_phits: int,
                adaptive: bool = False) -> torch.Tensor:
    """Frame B streams in one launch: payloads ``(B, Wcap)`` int32 lanes,
    ``nbytes (B,)``, ``routes (B, 3)`` (src, dst, seq0) and ``levels`` (an
    int or ``(B,)``) -> frames ``(B, F, 4 + 4 * frame_phits)`` with ``F =
    ceil(Wcap / (4 * frame_phits)) + 1`` (the size-0 terminator included),
    bit for bit ``framing.frame_parts_batch`` followed by the join:
    header ``[size | level | crc32 | route]`` with ``seq = (seq0 + f) mod
    2**16`` and the adaptive bit, the payload zeroed past each stream's
    ``ceil(nbytes / 4)`` words."""
    if payloads.dim() != 2 or payloads.dtype != torch.int32:
        raise ValueError(f"payloads must be (B, Wcap) int32 lanes, got {payloads.dtype} "
                         f"{tuple(payloads.shape)}")
    if frame_phits < 1:
        raise ValueError(f"frame_phits must be >= 1, got {frame_phits}")
    if not payloads.is_cuda:
        if payloads.device.type != "cpu":
            raise ValueError(f"unsupported device {payloads.device}: the kernels run on "
                             f"CUDA, their plain versions on the CPU")
        return frame_batch_plain(payloads, nbytes, routes, levels, frame_phits, adaptive)
    dev = payloads.device
    B, row_words = payloads.shape
    nb = torch.as_tensor(nbytes, dtype=torch.int64, device=dev)
    rt = torch.as_tensor(routes, dtype=torch.int64, device=dev)
    lv = torch.as_tensor(levels, dtype=torch.int64, device=dev)
    if nb.numel() != B or rt.numel() != 3 * B or lv.numel() not in (1, B):
        raise ValueError(f"nbytes {tuple(nb.shape)}, routes {tuple(rt.shape)} and levels "
                         f"{tuple(lv.shape)} do not match {B} streams as (B,), (B, 3) "
                         f"and (B,)")
    payloads, nb = payloads.contiguous(), nb.reshape(B).contiguous()
    rt, lv = rt.reshape(B, 3).contiguous(), lv.reshape(-1).expand(B).contiguous()
    frame_words = 4 * frame_phits
    F = -(-row_words // frame_words) + 1
    if B * F > _MAX_FRAMES or row_words + frame_words > _MAX_FRAMES:
        raise ValueError(f"{B} streams of {row_words} words in frames of {frame_phits} "
                         f"phits exceed one launch")
    tables, crc_xor = _crc_tables_on(dev, frame_phits)
    out = torch.empty((B, F, HDR_WORDS + frame_words), dtype=torch.int32, device=dev)
    if B:
        _launch("frame_batch", (payloads, nb, rt, lv, frame_phits, adaptive),
                "hgum_frame_batch", payloads.data_ptr(), nb.data_ptr(), rt.data_ptr(),
                lv.data_ptr(), tables.data_ptr(), out.data_ptr(), B, row_words, F,
                frame_phits, crc_xor, int(adaptive), _stream(out))
    return out


def unpack_frames_batch(frames: torch.Tensor, *, block: int = 8,
                        interpret: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``(N, 4 + frame_words)`` frames into (headers ``(N, 4)``,
    payloads ``(N, frame_words)``), both contiguous.  On the card they are
    views of one buffer (the payloads from ``N * 16`` bytes on, so whole
    phits stay 16-byte aligned), and one launch splits them (none for ``N
    = 0``): whole phits where ``frame_words % 4 == 0`` and the frames start
    on 16 bytes, single words otherwise.  ``block`` and ``interpret``
    describe the reference's Pallas grid; they are accepted and ignored."""
    if frames.dim() != 2 or frames.shape[1] < HDR_WORDS:
        raise ValueError(f"frames must be (N, 4 + frame_words), got {tuple(frames.shape)}")
    if _on_cpu(frames):
        return unpack_frames_batch_plain(frames)
    rows, width = frames.shape
    if rows * width > _MAX_WORDS:
        raise ValueError(f"{rows} frames of {width} words exceed one launch")
    frames = frames.contiguous()
    fw = width - HDR_WORDS
    out = torch.empty(rows * width, dtype=torch.int32, device=frames.device)
    hdr = out.as_strided((rows, HDR_WORDS), (HDR_WORDS, 1))
    pay = out.as_strided((rows, fw), (fw, 1), rows * HDR_WORDS)
    if rows:
        _launch("unpack_frames_batch", (frames,), "hgum_unpack_frames_batch",
                frames.data_ptr(), hdr.data_ptr(), pay.data_ptr(), rows, fw,
                _stream(frames))
    return hdr, pay


def pack_chunks_batch(meta: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor,
                      elem_words: int = 0, *, block: int = 8,
                      interpret: bool = True) -> torch.Tensor:
    """Fragment rows ``(B, capW + 4)`` from meta ``(B, 3)``, element words
    ``(B, capW)`` and element counts ``(B, 1)``: ``[stream_id, step, flags |
    capW words | count]``, the count after the elements (paper §IV-B).

    With the default ``elem_words=0`` the element words are copied as they
    are (the reference kernel's contract: pre-masked tokens); with
    ``elem_words >= 1`` the words past ``count * elem_words`` come out as
    zeros, the fused tail mask of ``ops.encode_chunks_batch``.  ``block``
    and ``interpret`` (the reference's Pallas grid) are accepted and
    ignored."""
    _check_chunks(meta, tokens, counts)
    if not 0 <= elem_words < 2**31:
        raise ValueError(f"elem_words must be >= 0 (0: no tail mask), got {elem_words}")
    if _on_cpu(meta, tokens, counts):
        return pack_chunks_batch_plain(meta, tokens, counts, elem_words)
    rows, cap_w = tokens.shape
    width = cap_w + CHUNK_META_WORDS + 1
    if rows * width > _MAX_WORDS or rows > _MAX_FRAMES or cap_w >= 2**30:
        raise ValueError(f"{rows} fragments of {width} words exceed one launch")
    meta, tokens, counts = meta.contiguous(), tokens.contiguous(), counts.contiguous()
    out = torch.empty((rows, width), dtype=torch.int32, device=meta.device)
    if rows:
        _launch("pack_chunks_batch", (meta, tokens, counts, elem_words),
                "hgum_pack_chunks_batch", meta.data_ptr(), tokens.data_ptr(),
                counts.data_ptr(), out.data_ptr(), rows, cap_w, elem_words, _stream(out))
    return out


def chunk_bursts(meta: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor,
                 elem_words: torch.Tensor, offsets: torch.Tensor,
                 n_words: int) -> torch.Tensor:
    """The trimmed form of :func:`pack_chunks_batch`: ``(n_words,)`` lanes
    holding row ``r`` as exactly ``[meta | live words | count]`` from word
    ``offsets[r]``, with ``live = min(counts * elem_words, capW)`` (a u32
    product) and ``elem_words`` ``(B, 1)`` per row.  ``offsets`` (``(B,)``
    int64) is the caller's prefix sum of the row lengths ``4 + live`` and
    ``n_words`` their total, so the rows abut; the plain version raises
    otherwise, and the kernel writes no word outside ``[0, n_words)``.
    One launch for every row (none for ``B = 0``)."""
    _check_chunk_bursts(meta, tokens, counts, elem_words, offsets)
    n_words = int(n_words)
    if _on_cpu(meta, tokens, counts, elem_words):
        return chunk_bursts_plain(meta, tokens, counts, elem_words, offsets, n_words)
    rows, cap_w = tokens.shape
    if rows > _MAX_FRAMES or cap_w >= 2**30 or max(rows * cap_w, n_words) > _MAX_WORDS:
        raise ValueError(f"{rows} fragments of {cap_w} words ({n_words} out) exceed one "
                         f"launch")
    meta, tokens, counts = meta.contiguous(), tokens.contiguous(), counts.contiguous()
    elem_words, offsets = elem_words.contiguous(), offsets.contiguous()
    out = torch.empty(n_words, dtype=torch.int32, device=meta.device)
    if rows:
        _launch("chunk_bursts", (meta, tokens, counts, elem_words, offsets, n_words),
                "hgum_chunk_bursts", meta.data_ptr(), tokens.data_ptr(), counts.data_ptr(),
                elem_words.data_ptr(), offsets.data_ptr(), out.data_ptr(), rows, cap_w,
                n_words, _stream(out))
    return out
