"""Routed message fabric: multi-hop framed transport between ranks, on one card.

Counterpart of the reference's ``fabric`` package.  Frames carry a ``(src,
dst, seq)`` route word, a :class:`Router` delivers them across arbitrary
hop counts under credit-based flow control (ranks are a tensor axis: a
hop is a roll of the rank grid), and a :class:`Mailbox` gives whole-message
``send(dst, wire)`` / ``recv()`` with CRC32 verification and
terminator-delimited reassembly.

Layers (each importable on its own):

* ``frames``  — wire format: CRC32, route words, frame/unframe;
* ``router``  — device-side multi-hop delivery over the rank axis;
* ``mailbox`` — host-side message API over the router (plus the ARQ
  retransmission layer, ``FabricConfig(arq=True)``);
* ``faults``  — seeded deterministic chaos injection (:class:`FaultPlan`),
  applied identically to both tick engines.
"""
from .faults import FaultPlan, parse_chaos
from .frames import (
    ADAPTIVE_BIT,
    FRAME_PHITS,
    HDR_WORDS,
    MAX_RANKS,
    PHIT_WORDS,
    SEQ_MOD,
    crc32_words,
    frame_capacity,
    frame_parts,
    frame_parts_batch,
    frame_stream,
    pack_route,
    route_adaptive,
    route_dst,
    route_seq,
    route_src,
    unframe_stream,
    unpack_route,
    verify_frames,
)
from .mailbox import Delivery, Fabric, FabricCorruption, Mailbox
from .router import FabricConfig, Router

__all__ = [
    "FaultPlan", "parse_chaos", "FabricCorruption",
    "ADAPTIVE_BIT", "FRAME_PHITS", "HDR_WORDS", "MAX_RANKS", "PHIT_WORDS",
    "SEQ_MOD", "crc32_words", "frame_capacity", "frame_parts",
    "frame_parts_batch", "frame_stream", "pack_route", "route_adaptive",
    "route_dst", "route_seq", "route_src", "unframe_stream", "unpack_route",
    "verify_frames",
    "Delivery", "Fabric", "Mailbox", "FabricConfig", "Router",
]
