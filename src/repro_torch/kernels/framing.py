"""The routed fabric's frame format and its structure pass, in plain torch.

The plain version of ``frame_pack.frame_batch`` and the reference its
kernel is held to; ``fabric.frames`` builds its framing API on it.  Every
function gives the same bits as the reference's ``fabric/frames.py``.

Frame layout (u32 words)::

    [ size | list_level | crc32 | route ] [ payload ... frame_words ]

* **CRC32** — a real CRC-32 (IEEE 802.3, the zlib polynomial) over
  ``size | list_level | route | payload`` (every word but the CRC slot),
  computed slicing-by-4: one 256-entry table per input byte lane, one step
  per u32 word.  :func:`crc32_words` runs vectorised over every frame at
  once and loops over the words of a frame (68 steps at
  ``frame_phits=16``).
* **route word** — ``adaptive:u1 | src:u7 | dst:u8 | seq:u16``; the
  ``adaptive`` bit is bit 31, so in the ``int32`` lane carrier an adaptive
  route word is negative.

Lane carrier: as in ``core.vectorized``, u32 words travel in ``int32``
tensors holding the same bits; arithmetic is done in ``int64``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.vectorized import u32_to_lanes

#: paper §V: 128-bit phits; frame = up to 500 phits (Altera 512-deep BRAM).
PHIT_WORDS = 4  # 16 B in u32 lanes
FRAME_PHITS = 500
SEQ_MOD = 1 << 16
ADAPTIVE_BIT = 1 << 31  # route-word flag: frame may take the -1 direction

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


#: (4, 256) uint32: T0 (byte at a time) ... T3
CRC_TABLES = _crc32_tables()


@functools.cache
def _tables(device: torch.device) -> torch.Tensor:
    """The four tables as one int64 (1024,) vector on ``device``, in the
    order the step reads them: T3 for byte 0, T2, T1, T0 for byte 3."""
    flat = np.ascontiguousarray(CRC_TABLES[::-1].reshape(-1), dtype=np.int64)
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


def as_i64(x, device=None) -> torch.Tensor:
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
    word = (((as_i64(src, dev) & 0x7F) << 24) | ((as_i64(dst, dev) & 0xFF) << 16)
            | (as_i64(seq, dev) & 0xFFFF))
    if adaptive:
        word = word | ADAPTIVE_BIT
    return u32_to_lanes(word)


def crc_input(sizes, levels, routes, data) -> torch.Tensor:
    """Words the frame CRC is computed over: size | level | route | payload."""
    return torch.cat(
        [sizes[..., None].to(torch.int64), levels[..., None].to(torch.int64),
         routes[..., None].to(torch.int64), data.to(torch.int64)], dim=-1)


def frame_structure(
    payloads: torch.Tensor,  # (B, W) int32 lanes
    nbytes: torch.Tensor,  # (B,) int64
    levels: torch.Tensor,  # (B,) int64
    frame_phits: int,
    routes: Optional[torch.Tensor],  # (B, 3) int64 (src, dst, seq0), or None
    adaptive: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Structure half of framing for B streams at once: (headers (B, F, 4),
    masked payload (B, F, frame_words), n_frames (B,)), ``F = ceil(W /
    frame_words) + 1``.  Without ``routes`` the route words are 0."""
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
    crc = crc32_words(crc_input(bytes_in, lv, route_words, data))
    hdr = torch.stack([u32_to_lanes(bytes_in), u32_to_lanes(lv), crc, route_words], dim=-1)
    n_frames = (words_in > 0).sum(dim=-1) + 1  # + empty terminator
    return hdr, data, n_frames


def frame_parts_batch(
    payloads_u32: torch.Tensor,  # (B, Wcap) int32 lanes
    nbytes,  # (B,)
    routes,  # (B, 3) — (src, dst, seq0) per stream
    list_level=1,  # int, or (B,) per-stream ListLevels
    frame_phits: int = FRAME_PHITS,
    adaptive: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``fabric.frames.frame_parts`` for multi-destination sends:
    one vectorised structure pass over B streams (the plain version of
    ``frame_pack.frame_batch``, without the join).  ``list_level`` may be
    per stream, so a mixed-tenant burst frames in one pass.  Returns
    (headers (B, F, 4), payload (B, F, frame_words), n_frames (B,))."""
    dev = payloads_u32.device
    B = payloads_u32.shape[0]
    return frame_structure(payloads_u32, as_i64(nbytes, dev).reshape(B),
                           as_i64(list_level, dev).expand(B), frame_phits,
                           as_i64(routes, dev).reshape(B, 3), adaptive)
