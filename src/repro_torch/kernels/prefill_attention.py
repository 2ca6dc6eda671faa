"""Prefill attention on the card: every query position of a prefill (or an
encoder, or a cross attention) over its keys, in one launch of a
hand-written CUDA kernel (``csrc/prefill_attention.cu``), beside its plain
PyTorch version.

:func:`attend` takes :func:`flash_attention`'s arguments and layout: q
(B, S, K, G, D) with K kv heads of G query heads each, k and v
(B, T, K, D); it returns (B, S, K, G, D) in q's dtype.  Its plain version
is :func:`flash_attention` (float32 casts of q and K, float32 GEMMs,
float32 score tiles in device memory, a masked online softmax), which
``models.common`` re-exports for the port's other callers.

The kernel replaces no TPU kernel: the reference's blocked attention is
plain jnp (``flash_attention``, ``src/repro/models/common.py``).  It is
bound by the tensor cores (causal attention over 1024 positions does about
256 flops a byte it must read); it keeps the scores in registers, skips the
key tiles that every row of a block masks, and packs a kv head's G query
heads into one block so each K/V tile serves them all; its source says
more.  The numbers are the plain version's: float32 scores (exact bf16
products summed in float32), float32 softmax, and ``p @ v`` with p in
float32 (carried to the tensor cores as three bf16 terms); with ``p_bf16``
p is rounded to bf16 as the plain version's cast does.  Only the order of
the float32 sums differs; out is rounded once to q's dtype.

Dispatch, by device alone: the plain version for tensors on the CPU (and
on ``meta``, the dry run's shape-only device); for CUDA tensors the kernel
or an exception, never a fallback.  Each launch adds one to
:data:`LAUNCHES`.  Under autograd the kernel still computes the forward;
its backward recomputes the plain version from the saved q, k and v and
takes that version's gradient (training's per-layer remat already pays
for a recompute, and the plain version's float32 score tiles then live
for one layer's backward only).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

#: a masked score: its exp is 0 against any row max a real key sets
NEG_INF = -1e30

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"prefill_attention": 0}

#: the widest head dim the kernel takes (any multiple of 16 up to it)
MAX_DIM = 128

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_SEGMENT_DTYPES = (torch.int32, torch.int64)

_SIGNATURE = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p,
]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library("prefill_attention")
    lib.hgum_prefill_attention.argtypes = _SIGNATURE
    lib.hgum_prefill_attention.restype = ctypes.c_int
    lib.hgum_error_string.argtypes = [ctypes.c_int]
    lib.hgum_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte boundary (the kernel copies its rows
    in 16-byte phits), copied only where it is not."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, segment_q=None, segment_k=None) -> Tuple[int, int, int, int, int, int]:
    """Validate a CUDA call; returns (B, S, T, K, G, D)."""
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"q must be (B, S, K, G, D) and k, v (B, T, K, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, K, G, D = q.shape
    T = k.shape[1]
    if k.shape != (B, T, K, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be {(B, T, K, D)} for q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes q, k and v in one of {list(_DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D % 16 or not 16 <= D <= MAX_DIM:
        raise ValueError(f"head dim must be a multiple of 16 up to {MAX_DIM}, got {D}")
    if S == 0 or T == 0:
        raise ValueError(f"the kernel takes at least one query and one key, got S {S}, T {T}")
    if (segment_q is None) != (segment_k is None):
        raise ValueError("segment_q and segment_k go together")
    if segment_q is not None and (
            segment_q.shape != (B, S) or segment_k.shape != (B, T)
            or segment_q.dtype not in _SEGMENT_DTYPES or segment_k.dtype not in _SEGMENT_DTYPES):
        raise ValueError(f"segment ids must be int32 or int64 {(B, S)} and {(B, T)}, got "
                         f"{segment_q.dtype} {tuple(segment_q.shape)} and "
                         f"{segment_k.dtype} {tuple(segment_k.shape)}")
    dev = q.device
    others = [k, v] + ([segment_q, segment_k] if segment_q is not None else [])
    if any(t.device != dev for t in others):
        raise ValueError(f"k, v and the segment ids must be on q's {dev}, got "
                         f"{[str(t.device) for t in others]}")
    return B, S, T, K, G, D


def flash_attention(
    q: torch.Tensor,  # (B, S, K, G, D)   K = kv heads, G = q heads per kv
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,  # (B, T, K, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
    segment_q: Optional[torch.Tensor] = None,  # (B, S)
    segment_k: Optional[torch.Tensor] = None,  # (B, T)
    kv_len: Optional[torch.Tensor] = None,  # valid prefix length of k/v
    block_q: int = 512,
    block_k: int = 1024,
    scale: Optional[float] = None,
    p_bf16: bool = False,
) -> torch.Tensor:
    """Double-blocked online-softmax attention, as the reference computes
    it: scores and ``p @ v`` in float32 (``p`` and ``v`` cast to bf16 for
    the product when ``p_bf16``), one (block_q, block_k) tile at a time, so
    (S, T) is never materialized.  Returns (B, S, K, G, D).

    A query attends to a key only where their segment ids are equal
    (packed sequences), and only to keys below ``kv_len``.  The reference
    pads S and T to whole blocks (pad segments -1 for queries, -2 for
    keys, never equal); here the last tiles are short instead, which masks
    the same keys: a padded key only ever adds ``exp(-1e30 - m) = 0``.
    Under autograd each tile's float32 scores are kept for the backward
    pass (per-layer remat bounds that to one layer)."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    block_q = min(block_q, S)
    block_k = min(block_k, T)
    dev = q.device
    t_end = T if kv_len is None else kv_len
    outs = []
    for q0 in range(0, S, block_q):
        qb = q[:, q0:q0 + block_q].float()
        bq = qb.shape[1]
        q_pos = q_offset + q0 + torch.arange(bq, device=dev)
        sqb = segment_q[:, q0:q0 + bq] if segment_q is not None else None
        acc = torch.zeros((B, bq, K, G, D), dtype=torch.float32, device=dev)
        m_run = torch.full((B, bq, K, G), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((B, bq, K, G), dtype=torch.float32, device=dev)
        for k0 in range(0, T, block_k):
            kb = k[:, k0:k0 + block_k].float()
            vb = v[:, k0:k0 + block_k]
            bk = kb.shape[1]
            k_pos = k0 + torch.arange(bk, device=dev)
            s = torch.einsum("bqkgd,btkd->bqkgt", qb, kb) * scale
            if logit_cap is not None:  # models.common.softcap
                s = logit_cap * torch.tanh(s / logit_cap)
            ok = (k_pos < t_end)[None, :].expand(bq, bk)
            if causal:
                ok = ok & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
            if sqb is not None:
                skb = segment_k[:, k0:k0 + bk]
                ok = ok[None] & (sqb[:, :, None] == skb[:, None, :])
            else:
                ok = ok[None]
            mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)  # (B?, bq, bk)
            s = s + mask[:, :, None, None, :]
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            if p_bf16:  # p is the (S, T) stream: bf16 halves its bytes
                pv = torch.einsum("bqkgt,btkd->bqkgd", p.to(torch.bfloat16),
                                  vb.to(torch.bfloat16)).float()
            else:
                pv = torch.einsum("bqkgt,btkd->bqkgd", p, vb.float())
            acc = acc * corr[..., None] + pv
            m_run = m_new
        outs.append(acc / torch.clamp(l_run[..., None], min=1e-30))
    return torch.cat(outs, dim=1).to(q.dtype)


def _launch(q, k, v, *, causal, window, logit_cap, q_offset, segment_q, segment_k, kv_len,
            scale, p_bf16) -> torch.Tensor:
    """One kernel launch on checked CUDA tensors; returns out."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B == 0 or K == 0 or G == 0:
        return out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if segment_q is not None:
        segment_q = segment_q.to(torch.int32).contiguous()
        segment_k = segment_k.to(torch.int32).contiguous()
        segs = (segment_q.data_ptr(), segment_k.data_ptr())
    else:
        segs = (None, None)
    n_keys = T if kv_len is None else min(max(int(kv_len), 0), T)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    idx = q.device.index if q.device.index is not None else torch.cuda.current_device()
    lib = _library()
    rc = lib.hgum_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *segs,
        B, S, T, K, G, D, _DTYPES[q.dtype], n_keys, int(causal), int(window is not None),
        int(window) if window is not None else 0, int(q_offset), float(scale),
        float(logit_cap) if logit_cap is not None else 0.0, int(bool(p_bf16)),
        torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        msg = lib.hgum_error_string(rc).decode()
        raise RuntimeError(f"prefill_attention: CUDA launch failed ({rc}: {msg})")
    LAUNCHES["prefill_attention"] += 1
    return out


class _Kernel(torch.autograd.Function):
    """The kernel as an autograd op: forward, one launch; backward, the
    plain version recomputed under autograd from the saved q, k and v, and
    its gradient of ``grad``."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return _launch(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
            out = flash_attention(*xs, **ctx.kw)
            wrt = [x for x in xs if x.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        return tuple(next(grads) if x.requires_grad else None for x in xs) + (None,)


def attend(
    q: torch.Tensor,  # (B, S, K, G, D)
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,  # (B, T, K, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
    segment_q: Optional[torch.Tensor] = None,  # (B, S)
    segment_k: Optional[torch.Tensor] = None,  # (B, T)
    kv_len=None,  # keys below it may be attended: an int or a one-element tensor
    scale: Optional[float] = None,
    p_bf16: bool = False,
) -> torch.Tensor:
    """:func:`flash_attention`'s function: on the CPU (and on ``meta``)
    that version, on a CUDA device one kernel launch (under autograd too,
    with the plain version's gradient).  Returns (B, S, K, G, D) in q's
    dtype."""
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset,
              segment_q=segment_q, segment_k=segment_k, kv_len=kv_len, scale=scale,
              p_bf16=p_bf16)
    if q.device.type in ("cpu", "meta"):
        return flash_attention(q, k, v, **kw)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}: the kernel runs on CUDA, its "
                         f"plain version on the CPU")
    _check(q, k, v, segment_q, segment_k)
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap must be positive or None, got {logit_cap}")
    return _Kernel.apply(q, k, v, kw)
