"""HGum DES payload pass on the card: phit stream -> u32 token lanes.

Three hand-written CUDA kernels (``csrc/phit_unpack.cu``), each beside a
plain PyTorch version with the same signature:

* :func:`unpack_run_aligned` — a uniform run whose ``base`` and ``stride``
  are multiples of 4: every lane is one word of the wire.  Replaces the
  Pallas body ``_run_kernel_aligned`` of ``repro.kernels.phit_unpack``.
* :func:`unpack_run_general` — a uniform run at any ``base``/``stride``:
  each lane is funnel-shifted out of two adjacent words.  Replaces
  ``_run_kernel_general``.
* :func:`unpack_gather` — one byte offset per row (ragged containers), the
  same shift-combine.  Replaces ``_gather_kernel``.

:func:`unpack_run` picks the aligned or the general kernel, as the
reference ``unpack_run`` picks its body.

Wire: 1-D ``int32`` tensor of little-endian u32 words (the port's lane
carrier, see ``core.vectorized``).  Outputs: ``(rows, ceil(nbytes/4))``
``int32`` lanes with the bytes past ``nbytes`` zeroed.  A word index
outside the wire reads as 0 in the kernels and in the plain versions alike
(the reference pads its wire with zeros for the same overread).

Dispatch: a wrapper takes its plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises; any other device
raises.  Each launch adds one to :data:`LAUNCHES`; inside
:func:`recording` it also records the call, so a path's calls can be
replayed as the path made them.

The reference's wrappers (:func:`unpack_run`, :func:`unpack_gather`) keep
its signatures: ``wire_u32`` first, and the keyword-only ``interpret`` of
the Pallas grid, which does not exist on the card.  It is accepted and
ignored; no argument selects a route.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..core.vectorized import lanes_to_i64, u32_to_lanes
from . import _build

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "unpack_run_aligned": 0,
    "unpack_run_general": 0,
    "unpack_gather": 0,
}

_SIGNATURES = {
    "hgum_unpack_run_aligned": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "hgum_unpack_run_general": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "hgum_unpack_gather": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}

#: inside :func:`recording`: (kernel, wire, args) of every launch
_RECORDED: Optional[List[Tuple[str, torch.Tensor, tuple]]] = None

# one launch covers at most 2**31 - 1 blocks of 256 threads
_MAX_WORDS = (2**31 - 1) * 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, torch.Tensor, tuple]]]:
    """Collect ``(kernel, wire, args)`` for every launch inside the block;
    ``wrapper(wire, *args)`` repeats the call."""
    global _RECORDED
    outer, _RECORDED = _RECORDED, []
    try:
        yield _RECORDED
    finally:
        _RECORDED = outer


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernels, with every entry point's C signature declared."""
    lib = _build.library("phit_unpack")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hgum_error_string.argtypes = [ctypes.c_int]
    lib.hgum_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kernel: str, call: Tuple[torch.Tensor, tuple], fn: str, *args) -> None:
    """Launch ``fn`` for the wrapper call ``call`` = (wire, args).  The entry
    point is the ctypes function object that :func:`_library` resolved and
    typed once (``CDLL`` keeps it as an attribute)."""
    lib = _library()
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.hgum_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")
    LAUNCHES[kernel] += 1
    if _RECORDED is not None:
        _RECORDED.append((kernel, *call))


def _on_cpu(wire: torch.Tensor, nbytes: int, rows: int) -> bool:
    """Validate the arguments, cheapest test first; True routes to the
    plain version."""
    if nbytes < 1:
        raise ValueError(f"nbytes must be >= 1, got {nbytes}")
    if rows < 0:
        raise ValueError(f"row count must be >= 0, got {rows}")
    if wire.dtype != torch.int32 or wire.dim() != 1 or not wire.is_contiguous():
        raise ValueError(
            f"wire must be a contiguous 1-D int32 tensor of u32 words, got "
            f"{wire.dtype} {tuple(wire.shape)}"
        )
    if wire.is_cuda:
        if rows * ((nbytes + 3) // 4) > _MAX_WORDS:
            raise ValueError(f"{rows} rows of {nbytes} bytes exceed one launch")
        return False
    if wire.device.type == "cpu":
        return True
    raise ValueError(f"unsupported device {wire.device}: the kernels run "
                     f"on CUDA, their plain versions on the CPU")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device, read
    anew on every call (a caller may switch streams between launches)
    without building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _lane_mask(nbytes: int, nlanes: int, device) -> torch.Tensor:
    """int64 (nlanes,) masks zeroing the bytes past ``nbytes``."""
    rem = nbytes - 4 * torch.arange(nlanes, dtype=torch.int64, device=device)
    return (torch.ones_like(rem) << (8 * rem.clamp(0, 4))) - 1


def _take_words(wire64: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """wire64[w], with 0 for every index outside the wire."""
    n = wire64.shape[0]
    if n == 0:
        return torch.zeros_like(w)
    inside = (w >= 0) & (w < n)
    return torch.where(inside, wire64[w.clamp(0, n - 1)], 0)


def _shift_gather(wire: torch.Tensor, row_offsets: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Plain shift-combine: lane j of row i is the u32 at byte
    ``row_offsets[i] + 4j``, computed in int64."""
    nlanes = (nbytes + 3) // 4
    dev = wire.device
    off = row_offsets[:, None] + 4 * torch.arange(nlanes, dtype=torch.int64, device=dev)[None]
    w = off >> 2
    r8 = 8 * (off & 3)
    wire64 = lanes_to_i64(wire)
    lo = _take_words(wire64, w)
    hi = _take_words(wire64, w + 1)
    # (hi:lo) >> 8r, low 32 bits; hi is cut to its low 8r bits first so the
    # shift never leaves 64 bits (and r == 0 takes nothing of hi)
    v = (lo >> r8) | ((hi & ((torch.ones_like(r8) << r8) - 1)) << (32 - r8))
    return u32_to_lanes(v & _lane_mask(nbytes, nlanes, dev)[None])


def _check_aligned(base: int, stride: int) -> None:
    if base % 4 or stride % 4:
        raise ValueError(f"aligned run needs base and stride multiples of 4, "
                         f"got base={base} stride={stride}")


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def unpack_run_aligned_plain(
    wire: torch.Tensor, base: int, stride: int, count: int, nbytes: int
) -> torch.Tensor:
    _check_aligned(base, stride)
    nlanes = (nbytes + 3) // 4
    dev = wire.device
    w = (base // 4
         + (stride // 4) * torch.arange(count, dtype=torch.int64, device=dev)[:, None]
         + torch.arange(nlanes, dtype=torch.int64, device=dev)[None])
    words = _take_words(lanes_to_i64(wire), w)
    return u32_to_lanes(words & _lane_mask(nbytes, nlanes, dev)[None])


def unpack_run_general_plain(
    wire: torch.Tensor, base: int, stride: int, count: int, nbytes: int
) -> torch.Tensor:
    rows = base + stride * torch.arange(count, dtype=torch.int64, device=wire.device)
    return _shift_gather(wire, rows, nbytes)


def unpack_gather_plain(
    wire: torch.Tensor, offsets: torch.Tensor, nbytes: int
) -> torch.Tensor:
    return _shift_gather(wire, offsets.to(torch.int64), nbytes)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def unpack_run_aligned(
    wire: torch.Tensor, base: int, stride: int, count: int, nbytes: int
) -> torch.Tensor:
    """``count`` rows at word ``base/4 + i*stride/4``; base, stride % 4 == 0."""
    base, stride, count, nbytes = int(base), int(stride), int(count), int(nbytes)
    _check_aligned(base, stride)
    if _on_cpu(wire, nbytes, count):
        return unpack_run_aligned_plain(wire, base, stride, count, nbytes)
    nlanes = (nbytes + 3) // 4
    out = torch.empty((count, nlanes), dtype=torch.int32, device=wire.device)
    if count:
        _launch("unpack_run_aligned", (wire, (base, stride, count, nbytes)),
                "hgum_unpack_run_aligned",
                wire.data_ptr(), wire.shape[0], out.data_ptr(), base // 4,
                stride // 4, count, nlanes, nbytes, _stream(wire))
    return out


def unpack_run_general(
    wire: torch.Tensor, base: int, stride: int, count: int, nbytes: int
) -> torch.Tensor:
    """``count`` rows at byte ``base + i*stride``, any alignment."""
    base, stride, count, nbytes = int(base), int(stride), int(count), int(nbytes)
    if _on_cpu(wire, nbytes, count):
        return unpack_run_general_plain(wire, base, stride, count, nbytes)
    nlanes = (nbytes + 3) // 4
    out = torch.empty((count, nlanes), dtype=torch.int32, device=wire.device)
    if count:
        _launch("unpack_run_general", (wire, (base, stride, count, nbytes)),
                "hgum_unpack_run_general",
                wire.data_ptr(), wire.shape[0], out.data_ptr(), base, stride,
                count, nlanes, nbytes, _stream(wire))
    return out


def unpack_gather(
    wire_u32: torch.Tensor, offsets: torch.Tensor, nbytes: int, *, interpret: bool = True
) -> torch.Tensor:
    """One row per byte offset in ``offsets`` (1-D int64, same device).

    ``interpret`` is the reference's Pallas switch; the card has no Pallas
    grid, so it is accepted and ignored (the tensor's device picks the
    route)."""
    wire, nbytes = wire_u32, int(nbytes)
    if offsets.dim() != 1:
        raise ValueError(f"offsets must be 1-D, got {tuple(offsets.shape)}")
    n = offsets.shape[0]
    if _on_cpu(wire, nbytes, n):
        return unpack_gather_plain(wire, offsets, nbytes)
    if (offsets.device != wire.device or offsets.dtype != torch.int64
            or not offsets.is_contiguous()):
        raise ValueError(
            f"offsets must be a contiguous int64 tensor on {wire.device}, got "
            f"{offsets.dtype} on {offsets.device}"
        )
    nlanes = (nbytes + 3) // 4
    out = torch.empty((n, nlanes), dtype=torch.int32, device=wire.device)
    if n:
        _launch("unpack_gather", (wire, (offsets, nbytes)), "hgum_unpack_gather",
                wire.data_ptr(), wire.shape[0], offsets.data_ptr(),
                out.data_ptr(), n, nlanes, nbytes, _stream(wire))
    return out


def unpack_run(
    wire_u32: torch.Tensor, base: int, stride: int, count: int, nbytes: int, *,
    interpret: bool = True
) -> torch.Tensor:
    """Uniform run: the aligned kernel when base and stride are multiples
    of 4, else the general one (the reference ``unpack_run``'s choice).
    ``interpret`` is accepted and ignored, as in :func:`unpack_gather`."""
    if int(base) % 4 == 0 and int(stride) % 4 == 0:
        return unpack_run_aligned(wire_u32, base, stride, count, nbytes)
    return unpack_run_general(wire_u32, base, stride, count, nbytes)
