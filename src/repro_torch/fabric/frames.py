"""Wire-level framing core of the routed fabric, in torch.

Counterpart of the reference's ``fabric/frames.py``; every function here
gives the same bits as the jnp one.  The paper's §IV-C HW-to-HW frame
header carries ``(size, ListLevel)``; the fabric adds two words:

* **CRC32** — a real CRC-32 (IEEE 802.3, the zlib polynomial), computed
  slicing-by-4: one 256-entry table per input byte lane, one step per u32
  word.  :func:`crc32_words` runs vectorised over every frame at once and
  loops over the words of a frame (68 steps at ``frame_phits=16``).
* **route word** — ``adaptive:u1 | src:u7 | dst:u8 | seq:u16``, so a frame
  is self-routing and the receiver reorders it per source by ``seq``
  (wraps at 2**16).  The ``adaptive`` bit is bit 31: in the port's
  ``int32`` lane carrier an adaptive route word is negative, so fields are
  read after widening to int64 and masking to 32 bits (logical shifts).

Frame layout (u32 words)::

    [ size | list_level | crc32 | route ] [ payload ... frame_words ]

The CRC covers ``size | list_level | route | payload`` (every word but the
CRC slot).  ``size`` is the true payload byte count of the frame; a size-0
frame is the end-of-list terminator and the end-of-message marker.

Lane carrier: as in ``core.vectorized``, u32 words travel in ``int32``
tensors holding the same bits; arithmetic is done in ``int64``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.vectorized import lanes_to_i64, u32_to_lanes

#: paper §V: 128-bit phits; frame = up to 500 phits (Altera 512-deep BRAM).
PHIT_WORDS = 4  # 16 B in u32 lanes
FRAME_PHITS = 500
HDR_WORDS = 4  # size, list_level, crc32, route -> one phit

#: header word indices
HDR_SIZE, HDR_LEVEL, HDR_CRC, HDR_ROUTE = 0, 1, 2, 3

_MASK32 = 0xFFFFFFFF


def _crc32_tables() -> np.ndarray:
    """Slicing-by-4 CRC-32 tables, (4, 256) uint32.

    ``T[0]`` is the classic byte-at-a-time table; ``T[k]`` advances a byte
    through ``k`` extra zero bytes, so one u32 word folds in a single step:
    ``crc' = T3[b0^crc] ^ T2[b1^(crc>>8)] ^ T1[b2^(crc>>16)] ^ T0[b3^(crc>>24)]``.
    """
    poly = np.uint32(0xEDB88320)
    t0 = np.zeros(256, np.uint64)
    for i in range(256):
        c = np.uint64(i)
        for _ in range(8):
            c = (c >> np.uint64(1)) ^ (np.uint64(poly) if c & np.uint64(1) else np.uint64(0))
        t0[i] = c
    tables = np.zeros((4, 256), np.uint64)
    tables[0] = t0
    for k in range(1, 4):
        tables[k] = t0[tables[k - 1] & np.uint64(0xFF)] ^ (tables[k - 1] >> np.uint64(8))
    return tables.astype(np.uint32)


_CRC_TABLES = _crc32_tables()


@functools.cache
def _tables(device: torch.device) -> torch.Tensor:
    """The four tables as one int64 (1024,) vector on ``device``, in the
    order the step reads them: T3 for byte 0, T2, T1, T0 for byte 3."""
    flat = np.ascontiguousarray(_CRC_TABLES[::-1].reshape(-1), dtype=np.int64)
    return torch.from_numpy(flat).to(device)


def crc32_words(words: torch.Tensor) -> torch.Tensor:
    """CRC-32 (zlib-compatible) of the little-endian bytes of u32 words.

    ``words`` is ``(..., n)`` (int32 lanes or int64 values); the result is
    ``(...,)`` int32 lanes, one CRC per row: row ``r`` equals
    ``zlib.crc32(words[r].tobytes())``.  One step per word, all rows at
    once (slicing-by-4: one gather of four table entries per step).
    """
    t = _tables(words.device)
    w64 = words.to(torch.int64) & _MASK32
    crc = torch.full(w64.shape[:-1], _MASK32, dtype=torch.int64, device=words.device)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=words.device)
    base = torch.arange(4, dtype=torch.int64, device=words.device) * 256
    for k in range(w64.shape[-1]):
        x = w64[..., k] ^ crc
        e = t[((x[..., None] >> shifts) & 0xFF) + base]  # (..., 4)
        crc = e[..., 0] ^ e[..., 1] ^ e[..., 2] ^ e[..., 3]
    return u32_to_lanes(crc ^ _MASK32)


# ---------------------------------------------------------------------------
# route word
# ---------------------------------------------------------------------------

MAX_RANKS = 128  # src is a u7 lane (bit 31 = adaptive flag); dst is u8
SEQ_MOD = 1 << 16
ADAPTIVE_BIT = 1 << 31  # route-word flag: frame may take the -1 direction


def route_word_budget() -> dict:
    """Static lane widths of the frame header: the u32 route word packs
    ``adaptive:u1|src:u7|dst:u8|seq:u16`` and the ListLevel header word
    carries a u8 lane."""
    return {
        "adaptive_bits": 1,
        "src_bits": 7,
        "dst_bits": 8,
        "seq_bits": 16,
        "level_bits": 8,
        "max_ranks": MAX_RANKS,
        "seq_mod": SEQ_MOD,
        "max_list_level": 255,
    }


def _i64(x, device=None) -> torch.Tensor:
    """An int, array or tensor as an int64 tensor (on ``device`` if given)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def pack_route(src, dst, seq, adaptive: bool = False) -> torch.Tensor:
    """(src, dst, seq) -> route word ``adaptive:u1|src:u7|dst:u8|seq:u16``
    as int32 lanes (broadcast over the three arguments).

    ``adaptive`` sets the shortest-path flag: the router may move the frame
    in the -1 ring direction on an axis when that way is shorter.
    """
    dev = next((x.device for x in (src, dst, seq) if isinstance(x, torch.Tensor)), None)
    word = (((_i64(src, dev) & 0x7F) << 24) | ((_i64(dst, dev) & 0xFF) << 16)
            | (_i64(seq, dev) & 0xFFFF))
    if adaptive:
        word = word | ADAPTIVE_BIT
    return u32_to_lanes(word)


def unpack_route(word) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route word(s) -> (src, dst, seq) int64."""
    w = _i64(word) & _MASK32
    return (w >> 24) & 0x7F, (w >> 16) & 0xFF, w & 0xFFFF


def _route(frames: torch.Tensor) -> torch.Tensor:
    return frames[..., HDR_ROUTE].to(torch.int64) & _MASK32


def route_src(frames: torch.Tensor) -> torch.Tensor:
    """(…, width) frames -> (…,) src rank (int64)."""
    return (_route(frames) >> 24) & 0x7F


def route_dst(frames: torch.Tensor) -> torch.Tensor:
    return (_route(frames) >> 16) & 0xFF


def route_seq(frames: torch.Tensor) -> torch.Tensor:
    return _route(frames) & 0xFFFF


def route_adaptive(frames: torch.Tensor) -> torch.Tensor:
    """(…, width) frames -> (…,) bool: shortest-path routing allowed."""
    return (_route(frames) >> 31) != 0


# ---------------------------------------------------------------------------
# framing / unframing (static frame capacity)
# ---------------------------------------------------------------------------


def _crc_input(sizes, levels, routes, data) -> torch.Tensor:
    """Words the frame CRC is computed over: size | level | route | payload."""
    return torch.cat(
        [sizes[..., None].to(torch.int64), levels[..., None].to(torch.int64),
         routes[..., None].to(torch.int64), data.to(torch.int64)], dim=-1)


def _frame_parts(
    payloads: torch.Tensor,  # (B, W) int32 lanes
    nbytes: torch.Tensor,  # (B,) int64
    levels: torch.Tensor,  # (B,) int64
    frame_phits: int,
    routes: Optional[torch.Tensor],  # (B, 3) int64 (src, dst, seq0), or None
    adaptive: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Structure half of framing for B streams at once: (headers (B, F,
    HDR_WORDS), masked payload (B, F, frame_words), n_frames (B,))."""
    frame_words = frame_phits * PHIT_WORDS
    B, W = payloads.shape
    dev = payloads.device
    F = -(-W // frame_words) + 1  # + terminator
    data = torch.nn.functional.pad(payloads, (0, F * frame_words - W))
    data = data.reshape(B, F, frame_words)
    word_len = (nbytes + 3) // 4
    start = torch.arange(F, dtype=torch.int64, device=dev) * frame_words
    words_in = (word_len[:, None] - start).clamp(min=0).clamp(max=frame_words)
    bytes_in = (nbytes[:, None] - start * 4).clamp(min=0).clamp(max=frame_words * 4)
    # zero tail garbage inside each frame
    col = torch.arange(frame_words, dtype=torch.int64, device=dev)
    data = torch.where(col < words_in[..., None], data, 0)
    if routes is None:
        route_words = torch.zeros((B, F), dtype=torch.int32, device=dev)
    else:
        seq = (routes[:, 2:3] + torch.arange(F, dtype=torch.int64, device=dev)) % SEQ_MOD
        route_words = pack_route(routes[:, 0:1], routes[:, 1:2], seq, adaptive=adaptive)
    lv = (levels[:, None] & _MASK32).expand(B, F)
    # the CRC covers the OTHER header words too (size, level, route)
    crc = crc32_words(_crc_input(bytes_in, lv, route_words, data))
    hdr = torch.stack([u32_to_lanes(bytes_in), u32_to_lanes(lv), crc, route_words], dim=-1)
    n_frames = (words_in > 0).sum(dim=-1) + 1  # + empty terminator
    return hdr, data, n_frames


def frame_parts(
    payload_u32: torch.Tensor,  # (W,) int32 lanes — serialized list data
    nbytes,  # true byte length
    list_level=1,
    frame_phits: int = FRAME_PHITS,
    route: Optional[Tuple] = None,  # (src, dst, seq0), or None
    adaptive: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Structure half of framing: (headers (F, HDR_WORDS), masked payload
    (F, frame_words), n_frames).  ``frame_stream`` joins the two; the
    ``pack_frames_batch`` kernel does so on the card."""
    dev = payload_u32.device
    routes = None if route is None else _i64(list(route), dev)[None]
    hdr, data, n = _frame_parts(
        payload_u32[None], _i64([nbytes], dev).reshape(1), _i64([list_level], dev).reshape(1),
        frame_phits, routes, adaptive)
    return hdr[0], data[0], n[0]


def frame_stream(
    payload_u32: torch.Tensor,
    nbytes,
    list_level: int = 1,
    frame_phits: int = FRAME_PHITS,
    route: Optional[Tuple] = None,
    adaptive: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cut a byte stream into frames: (frames (F, HDR_WORDS + frame_words)
    int32 lanes, n_frames).  F is the static capacity bound incl. the empty
    end-of-list terminator.  With ``route`` set, every frame carries a
    ``(src, dst, seq0 + i)`` route word (terminator included)."""
    hdr, data, n_frames = frame_parts(
        payload_u32, nbytes, list_level, frame_phits, route, adaptive=adaptive
    )
    return torch.cat([hdr, data], dim=-1), n_frames


def frame_parts_batch(
    payloads_u32: torch.Tensor,  # (B, Wcap) int32 lanes
    nbytes,  # (B,)
    routes,  # (B, 3) — (src, dst, seq0) per stream
    list_level=1,  # int, or (B,) per-stream ListLevels
    frame_phits: int = FRAME_PHITS,
    adaptive: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``frame_parts`` for multi-destination sends: one vectorised
    structure pass over B streams.  ``list_level`` may be per stream, so a
    mixed-tenant burst frames in one pass.  Returns (headers (B, F,
    HDR_WORDS), payload (B, F, frame_words), n_frames (B,))."""
    dev = payloads_u32.device
    B = payloads_u32.shape[0]
    return _frame_parts(payloads_u32, _i64(nbytes, dev).reshape(B),
                        _i64(list_level, dev).expand(B), frame_phits,
                        _i64(routes, dev).reshape(B, 3), adaptive)


def verify_frames(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame CRC check (headers included): (…, F, width) -> (…, F) bool."""
    got = crc32_words(_crc_input(frames[..., HDR_SIZE], frames[..., HDR_LEVEL],
                                 frames[..., HDR_ROUTE], frames[..., HDR_WORDS:]))
    return got == frames[..., HDR_CRC]


def unframe_stream(
    frames: torch.Tensor, verify: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frames -> (payload (W,) int32 lanes, nbytes, ok).  Zeroed past the
    true end."""
    F = frames.shape[0]
    data = frames[:, HDR_WORDS:]
    bytes_in = lanes_to_i64(frames[:, HDR_SIZE])
    ok = torch.tensor(True, device=frames.device)
    if verify:
        ok = verify_frames(frames).all()
    # terminator = first frame with size 0; frames after it are ignored
    first_end = torch.argmax((bytes_in == 0).to(torch.int32))
    live = torch.arange(F, device=frames.device) < first_end
    nbytes = torch.where(live, bytes_in, 0).sum()
    payload = torch.where(live[:, None], data, 0).reshape(-1)
    return payload, nbytes, ok


def frame_capacity(wire_bytes: int, frame_phits: int) -> int:
    """Frames emitted for a wire of ``wire_bytes`` (incl. the terminator)."""
    frame_words = frame_phits * PHIT_WORDS
    words = -(-wire_bytes // 4)
    return -(-words // frame_words) + 1  # 0 bytes -> terminator only
