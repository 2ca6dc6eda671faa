"""Wire-level framing core of the routed fabric, in torch.

Counterpart of the reference's ``fabric/frames.py``; every function here
gives the same bits as the jnp one.  The paper's §IV-C HW-to-HW frame
header carries ``(size, ListLevel)``; the fabric adds two words:

* **CRC32** — a real CRC-32 (IEEE 802.3, the zlib polynomial), computed
  slicing-by-4 by ``kernels.framing.crc32_words``: vectorised over every
  frame at once, one step per word of a frame (68 steps at
  ``frame_phits=16``).  The structure pass that builds the headers lives
  beside it in ``kernels.framing`` (the plain version of the
  ``frame_batch`` kernel, with which the fabric frames on the card); here
  it is the RX check, :func:`verify_frames`.
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

from typing import Optional, Tuple

import torch

from ..core.vectorized import lanes_to_i64
# the frame format's structure half is the kernels layer's; re-exported here
# as part of the fabric's frame API
from ..kernels.framing import (  # noqa: F401
    ADAPTIVE_BIT,
    FRAME_PHITS,
    PHIT_WORDS,
    SEQ_MOD,
    as_i64,
    crc32_words,
    crc_input,
    frame_parts_batch,
    frame_structure,
    pack_route,
)
from ..kernels.frame_pack import pack_frames_batch

HDR_WORDS = 4  # size, list_level, crc32, route -> one phit

#: header word indices
HDR_SIZE, HDR_LEVEL, HDR_CRC, HDR_ROUTE = 0, 1, 2, 3

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# route word
# ---------------------------------------------------------------------------

MAX_RANKS = 128  # src is a u7 lane (bit 31 = adaptive flag); dst is u8


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


def unpack_route(word) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route word(s) -> (src, dst, seq) int64."""
    w = as_i64(word) & _MASK32
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


def frame_parts(
    payload_u32: torch.Tensor,  # (W,) int32 lanes — serialized list data
    nbytes,  # true byte length
    list_level=1,
    frame_phits: int = FRAME_PHITS,
    route: Optional[Tuple] = None,  # (src, dst, seq0), or None
    adaptive: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Structure half of framing: (headers (F, HDR_WORDS), masked payload
    (F, frame_words), n_frames).  ``frame_stream`` joins the two with the
    ``pack_frames_batch`` kernel (its plain version on the CPU)."""
    dev = payload_u32.device
    routes = None if route is None else as_i64(list(route), dev)[None]
    hdr, data, n = frame_structure(
        payload_u32[None], as_i64([nbytes], dev).reshape(1),
        as_i64([list_level], dev).reshape(1), frame_phits, routes, adaptive)
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
    ``(src, dst, seq0 + i)`` route word (terminator included).  The
    headers come from the structure pass; the join is the
    ``pack_frames_batch`` kernel (B5 with given headers).  The batched
    fabric frames with ``kernels.frame_pack.frame_batch`` instead, which
    builds the headers in the kernel too."""
    hdr, data, n_frames = frame_parts(
        payload_u32, nbytes, list_level, frame_phits, route, adaptive=adaptive
    )
    return pack_frames_batch(hdr, data), n_frames


def verify_frames(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame CRC check (headers included): (…, F, width) -> (…, F) bool."""
    got = crc32_words(crc_input(frames[..., HDR_SIZE], frames[..., HDR_LEVEL],
                                 frames[..., HDR_ROUTE], frames[..., HDR_WORDS:]))
    return got == frames[..., HDR_CRC]


def unframe_stream(
    frames: torch.Tensor, verify: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frames (F, width) -> (payload (W,) int32 lanes, nbytes, ok).  Zeroed
    past the true end.  Leading dims are streams unframed side by side:
    (..., F, width) -> (payload (..., W), nbytes (...), ok (...))."""
    F = frames.shape[-2]
    data = frames[..., HDR_WORDS:]
    bytes_in = lanes_to_i64(frames[..., HDR_SIZE])
    ok = torch.ones(frames.shape[:-2], dtype=torch.bool, device=frames.device)
    if verify:
        ok = verify_frames(frames).all(dim=-1)
    # terminator = first frame with size 0; frames after it are ignored
    first_end = torch.argmax((bytes_in == 0).to(torch.int32), dim=-1)
    live = torch.arange(F, device=frames.device) < first_end[..., None]
    nbytes = torch.where(live, bytes_in, 0).sum(dim=-1)
    payload = torch.where(live[..., None], data, 0).reshape(*frames.shape[:-2], -1)
    return payload, nbytes, ok


def frame_capacity(wire_bytes: int, frame_phits: int) -> int:
    """Frames emitted for a wire of ``wire_bytes`` (incl. the terminator)."""
    frame_words = frame_phits * PHIT_WORDS
    words = -(-wire_bytes // 4)
    return -(-words // frame_words) + 1  # 0 bytes -> terminator only
