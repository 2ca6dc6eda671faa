"""Typed inter-device channels: the HW-to-HW direction.

Counterpart of ``repro.runtime.channels``.  A *framed channel* moves a
variable-length byte stream (a List in HGum terms) between mesh
neighbours as fixed-size frames with ``(size, ListLevel)`` headers — the
paper's §IV-C protocol — plus the CRC32 and route words of the routed
fabric.  An empty frame terminates the list.

The framing core is shared with the routed fabric (``fabric.frames``), so
the wire format cannot drift between the neighbour channel and the
multi-hop router; for arbitrary-rank delivery use ``fabric.Fabric``.

On one card a mesh axis is a tensor axis: the members of a send are the
rows of its ``(n, ...)`` inputs, and the reference's ``ppermute`` one hop
around the ring is a ``torch.roll`` along that axis.  The sender frames
all ``n`` members in one structure pass and one launch of B5's join
(``kernels.frame_pack.pack_frames_batch``; its plain version on the CPU).
"""
from __future__ import annotations

import torch

from ..fabric.frames import (  # noqa: F401  (re-exported public API)
    FRAME_PHITS,
    HDR_WORDS,
    PHIT_WORDS,
    crc32_words,
    frame_stream,
    unframe_stream,
)
from ..kernels.frame_pack import pack_frames_batch
from ..kernels.framing import as_i64, frame_structure
from ..launch.costanalysis import record_collective

__all__ = [
    "FRAME_PHITS", "HDR_WORDS", "PHIT_WORDS", "crc32_words",
    "frame_stream", "unframe_stream", "pod_ring_exchange",
    "make_framed_sender",
]


def pod_ring_exchange(frames: torch.Tensor, axis: int = 0, shift: int = 1) -> torch.Tensor:
    """Move every member's framed stream ``shift`` hops around the ring of
    tensor axis ``axis``: member ``i`` receives what member ``i - shift``
    sent.  The framed stream is self-describing, so the receiver decodes
    it without out-of-band length metadata — the paper's point."""
    record_collective("collective-permute", frames)
    return torch.roll(frames, shifts=shift, dims=axis)


def make_framed_sender(mesh, axis_name: str, frame_phits: int = FRAME_PHITS):
    """A send along ``axis_name`` of ``mesh``.

    ``send(payload, nbytes)`` takes per-member payloads stacked on dim 0:
    payload ``(n, W)`` u32 lanes (int32) and nbytes ``(n,)``, ``n`` the
    axis's size, and returns the rotated ``(payload (n, W'), nbytes (n,),
    ok (n,))``: member ``i`` holds what member ``i - 1`` sent, ``W'`` the
    frames' payload capacity, zeroed past each stream's end."""
    n = mesh.shape[axis_name]

    def send(payload_u32: torch.Tensor, nbytes):
        if payload_u32.shape[0] != n:
            raise ValueError(f"payload has {payload_u32.shape[0]} members; "
                             f"axis {axis_name!r} has {n}")
        dev = payload_u32.device
        nb = as_i64(nbytes, dev).reshape(n)
        hdr, data, _ = frame_structure(payload_u32, nb, torch.ones_like(nb),
                                       frame_phits, None, False)
        frames = pack_frames_batch(hdr, data)  # (n, F, HDR_WORDS + frame_words)
        return unframe_stream(pod_ring_exchange(frames))

    return send
