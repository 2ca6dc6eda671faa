"""Oracles for the HGum kernels under the reference's names
(counterpart of ``repro.kernels.ref``).

The reference keeps a second, pure-``jnp`` copy of each kernel's
arithmetic for its tests.  The port's oracles are its kernels' plain
PyTorch versions (``phit_unpack.*_plain``, ``frame_pack.*_plain``), which
the CUDA kernels are held to on the card; this module gives them the
reference's names and signatures rather than a third copy.  Lanes are
``int32`` tensors holding u32 bits (the port's carrier); numpy ``uint32``
or ``int32`` arrays are taken as the same bits.

One difference is by design: a row that reaches past the wire reads zeros
here (as the kernels do), where the reference's ``decode_leaf`` clips to
the wire's last byte; rows inside the wire are equal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.vectorized import lanes_to_i64, u32_to_lanes
from .frame_pack import pack_run_plain, stamp_headers_plain
from .phit_unpack import (
    unpack_gather_plain,
    unpack_run_aligned_plain,
    unpack_run_general_plain,
)


def _lanes(x) -> torch.Tensor:
    """u32 lanes as an ``int32`` tensor (a tensor passes through)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if a.dtype not in (np.uint32, np.int32):
        a = a.astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy())


def wire_u32_to_u8(wire_u32) -> torch.Tensor:
    """uint32 lanes -> little-endian uint8 stream."""
    return _lanes(wire_u32).contiguous().view(torch.uint8).reshape(-1)


def unpack_run_ref(wire_u32, base: int, stride: int, count: int, nbytes: int) -> torch.Tensor:
    """Oracle for ``phit_unpack.unpack_run``: the aligned or general plain
    version, as ``unpack_run`` picks its kernel."""
    wire = _lanes(wire_u32)
    if base % 4 == 0 and stride % 4 == 0:
        return unpack_run_aligned_plain(wire, base, stride, count, nbytes)
    return unpack_run_general_plain(wire, base, stride, count, nbytes)


def unpack_gather_ref(wire_u32, offsets, nbytes: int) -> torch.Tensor:
    """Oracle for ``phit_unpack.unpack_gather``."""
    wire = _lanes(wire_u32)
    offs = torch.as_tensor(np.asarray(offsets) if not isinstance(offsets, torch.Tensor)
                           else offsets, dtype=torch.int64, device=wire.device)
    return unpack_gather_plain(wire, offs.reshape(-1), nbytes)


def pack_run_ref(tokens, stride: int, nbytes: int) -> torch.Tensor:
    """Oracle for ``frame_pack.pack_run``: lanes at a pitch of ``stride``."""
    return pack_run_plain(_lanes(tokens), stride, nbytes)


def stamp_headers_ref(wire_u32, headers) -> torch.Tensor:
    """Oracle for ``frame_pack.stamp_headers``: ``(word, size, level)``
    rows; where two headers' slots meet, the later header wins."""
    wire = _lanes(wire_u32)
    if isinstance(headers, torch.Tensor):
        h = headers.to(torch.int64)
    else:
        h = torch.from_numpy(np.asarray(headers).astype(np.int64))
    h = h.reshape(-1, 3).to(wire.device)
    table = torch.stack([h[:, 0].to(torch.int32),
                         u32_to_lanes(lanes_to_i64(h[:, 1])),
                         u32_to_lanes(lanes_to_i64(h[:, 2]))], dim=1)
    return stamp_headers_plain(wire, table)
