"""Decode attention on the card: append one token's K/V to the cache and
attend over it, in one launch of a hand-written CUDA kernel
(``csrc/decode_attention.cu``), beside its plain PyTorch version.

:func:`append_and_attend` is the tail of ``models.attention.attn_decode``
after RoPE: write this step's ``k``/``v`` into the caches at ``pos`` (a
ring under a window; a row whose slot lies past the cache keeps its old
K/V, as the reference's ``mode="drop"`` scatter), then attend ``q`` over
the cache's first ``kv_len`` keys.  :func:`append_and_attend_plain` does it
as the port always has: an advanced-index write, then
``models.common.decode_attention`` (float32 casts of the whole cache, two
einsums, a masked softmax).

The kernel replaces no TPU kernel: the reference's ``decode_attention``
is plain jnp (``src/repro/models/common.py:242``).  It reads the cache
once in its own dtype, where the plain version moves about eight times
its bytes through float32 copies; its source says what bounds it and how
it is laid out.  The numbers are the reference's: float32 scores, softmax
and ``p @ v`` (``p`` float32), one rounding to q's dtype at the end; only
the order of the float32 sums differs.

Dispatch: the plain version for tensors on the CPU (and on ``meta``, the
dry run's shape-only device); for CUDA tensors the kernel or an
exception, never a fallback.  Each launch adds one to
:data:`LAUNCHES`.  The launch reads ``pos`` on the device and never
synchronises, so a CUDA graph can capture it (its scratch comes from the
caching allocator; its tickets, allocated on the first call of a shape
class, are reset by the kernel itself).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"decode_attention": 0}

#: keys a warp tile holds, and warps a block (``csrc/decode_attention.cu``)
TILE, WARPS = 32, 2
#: widest head group a block holds in registers, and the widest head dim
MAX_GROUP, MAX_DIM = 8, 128
#: the head-group widths the kernel is built for (``gc_max``)
GROUP_WIDTHS = (1, 2, 4, 6, 8)
#: blocks per SM a launch aims for before it splits the keys further
BLOCKS_PER_SM = 2

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_SIGNATURE = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]

#: device index -> int32 tickets, zero between launches
_TICKETS: Dict[int, torch.Tensor] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    lib.hgum_decode_attention.argtypes = _SIGNATURE
    lib.hgum_decode_attention.restype = ctypes.c_int
    lib.hgum_error_string.argtypes = [ctypes.c_int]
    lib.hgum_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan(B: int, K: int, G: int, T: int, n_sm: int) -> Dict[str, int]:
    """The launch's shape from the call's: query heads per block (``gc``,
    at most :data:`MAX_GROUP`, held in registers ``gc_max`` wide, the
    narrowest of :data:`GROUP_WIDTHS` that holds them), head groups, and
    key splits.  Splits are added while the blocks (rows x kv heads x
    groups x splits) stay under :data:`BLOCKS_PER_SM` per SM, each split at
    least one tile for each warp; ``kv_len`` lives on the device and plays
    no part.  Memoised: the decode step asks once a layer."""
    return _plan(B, K, G, T, n_sm, BLOCKS_PER_SM)


@functools.lru_cache(maxsize=1024)
def _plan(B: int, K: int, G: int, T: int, n_sm: int, blocks_per_sm: int) -> Dict[str, int]:
    n_groups = -(-G // MAX_GROUP)
    gc = -(-G // n_groups)
    gc_max = min(w for w in GROUP_WIDTHS if w >= gc)
    units = B * K * n_groups
    step = TILE * WARPS
    max_splits = -(-T // step)
    n_splits = min(max_splits, max(1, -(-blocks_per_sm * n_sm // units)))
    split_len = -(-T // n_splits)
    split_len = -(-split_len // step) * step
    n_splits = -(-T // split_len)
    return {"gc": gc, "gc_max": gc_max, "n_groups": n_groups, "n_splits": n_splits,
            "split_len": split_len}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    t = _TICKETS.get(idx)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 2 * (0 if t is None else t.numel())), dtype=torch.int32,
                        device=device)
        _TICKETS[idx] = t
    return t


def _aligned(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous at a 16-byte boundary (the kernel
    copies its rows in 16-byte phits), copied only where it is not."""
    if t.dtype != dtype:
        t = t.to(dtype)
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# plain version (CPU path, and what the kernel is held to)
# ---------------------------------------------------------------------------


def append_and_attend_plain(
    q: torch.Tensor,  # (B, 1, K, G, D)
    k: torch.Tensor,  # (B, K, D)
    v: torch.Tensor,  # (B, K, D)
    k_cache: torch.Tensor,  # (B, T, K, D), written in place
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # (B,) absolute position of this token
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Write ``k``/``v`` at ``pos`` (``pos % T`` under a window), dropping a
    row whose slot is ``>= T``, then ``models.common.decode_attention`` over
    ``kv_len`` keys.  The drop is a select on the device, so it needs no
    host sync.  Returns (B, 1, K, G, D) in q's dtype."""
    from ..models.common import decode_attention

    B, T = k_cache.shape[:2]
    slot = pos % T if window is not None else pos  # ring buffer for SWA
    keep = (slot < T)[:, None, None]
    slot = slot.clamp(max=T - 1).long()
    b_idx = torch.arange(B, device=q.device)
    k_cache[b_idx, slot] = torch.where(keep, k.to(k_cache.dtype), k_cache[b_idx, slot])
    v_cache[b_idx, slot] = torch.where(keep, v.to(v_cache.dtype), v_cache[b_idx, slot])
    kv_len = torch.clamp(pos + 1, max=T) if window is not None else pos + 1
    return decode_attention(q, k_cache, v_cache, kv_len, logit_cap=logit_cap)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _check(q, k, v, k_cache, v_cache, pos) -> Tuple[int, int, int, int, int]:
    """Validate a CUDA call (on the decode step's path: shapes compared as
    ``torch.Size`` against tuples, nothing built that a passing call does
    not need); returns (B, T, K, G, D)."""
    if k_cache.dim() != 4 or q.dim() != 5:
        raise ValueError(f"q must be (B, 1, K, G, D) and the caches (B, T, K, D), got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, T, K, D = k_cache.shape
    G = q.shape[3]
    if q.shape != (B, 1, K, G, D):
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(k_cache.shape)}")
    if k.shape != (B, K, D) or v.shape != (B, K, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"k and v must be {(B, K, D)} and v_cache {(B, T, K, D)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(v_cache.shape)}")
    dtype = k_cache.dtype
    if dtype not in _DTYPES or q.dtype != dtype or v_cache.dtype != dtype:
        raise ValueError(f"the kernel takes q and both caches in one of "
                         f"{list(_DTYPES)}, got q {q.dtype}, caches {dtype}, {v_cache.dtype}")
    if D % 16 or D > MAX_DIM:
        raise ValueError(f"head dim must be a multiple of 16 up to {MAX_DIM}, got {D}")
    if pos.dtype not in (torch.int32, torch.int64) or pos.shape != (B,):
        raise ValueError(f"pos must be (B,) int32 or int64, got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    dev = k_cache.device
    if not (q.device == k.device == v.device == v_cache.device == pos.device == dev):
        raise ValueError(f"q, k, v, v_cache and pos must be on the caches' {dev}, got "
                         f"{q.device}, {k.device}, {v.device}, {v_cache.device}, {pos.device}")
    if (not k_cache.is_contiguous() or not v_cache.is_contiguous()
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError("k_cache and v_cache must be contiguous and 16-byte aligned")
    return B, T, K, G, D


def append_and_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """:func:`append_and_attend_plain`'s function: on the CPU (and on the
    ``meta`` device, whose tensors carry shapes only) that version, on a
    CUDA device one kernel launch, which writes the caches in place and
    returns (B, 1, K, G, D) in q's dtype."""
    if q.device.type in ("cpu", "meta"):  # meta: the dry run's shapes, no data
        return append_and_attend_plain(q, k, v, k_cache, v_cache, pos, window=window,
                                       logit_cap=logit_cap)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}: the kernel runs on CUDA, its "
                         f"plain version on the CPU")
    B, T, K, G, D = _check(q, k, v, k_cache, v_cache, pos)
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap must be positive or None, got {logit_cap}")
    dev = k_cache.device
    q, pos = q.contiguous(), pos.contiguous()
    k, v = _aligned(k, k_cache.dtype), _aligned(v, k_cache.dtype)
    out = torch.empty_like(q)
    if B == 0:
        return out
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    p = plan(B, K, G, T, _sm_count(idx))
    parts = B * K * p["n_groups"] * p["n_splits"] * p["gc"]
    if p["n_splits"] > 1:
        part_acc = torch.empty(parts * D, dtype=torch.float32, device=dev)
        part_ml = torch.empty(2 * parts, dtype=torch.float32, device=dev)
        tickets = _tickets(dev, B * K * p["n_groups"])
        scratch = (part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr())
    else:
        scratch = (0, 0, 0)
    lib = _library()
    rc = lib.hgum_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos.data_ptr(), out.data_ptr(), *scratch,
        B, T, K, G, D, _DTYPES[k_cache.dtype], int(pos.dtype == torch.int64),
        int(window is not None), 1.0 / math.sqrt(D),
        float(logit_cap) if logit_cap is not None else 0.0,
        p["gc"], p["gc_max"], p["n_groups"], p["n_splits"], p["split_len"],
        torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        msg = lib.hgum_error_string(rc).decode()
        raise RuntimeError(f"decode_attention: CUDA launch failed ({rc}: {msg})")
    LAUNCHES["decode_attention"] += 1
    return out
