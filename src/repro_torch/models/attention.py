"""Attention layers: GQA/MQA/MHA with RoPE and sliding windows (plain torch).

Counterpart of ``repro.models.attention``: ``init_attn``, ``_qkv``,
``attn_forward`` (full sequence, returns the new KV), ``attn_decode``
(one token against a KV cache) and the encoder-decoder cross attention
(``init_cross_attn``, ``cross_kv``, ``cross_attn_forward``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attention import append_and_attend
from ..kernels.prefill_attention import attend
from .common import _param, apply_rope, dense_init


class Attention(torch.nn.Module):
    """``wq`` (d, nq*hd), ``wk``/``wv`` (d, nkv*hd), ``wo`` (nq*hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        d, hd, nq, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
        init = dict(generator=generator, dtype=dtype, device=device)
        self.wq = _param(dense_init((d, nq * hd), **init))
        self.wk = _param(dense_init((d, nkv * hd), **init))
        self.wv = _param(dense_init((d, nkv * hd), **init))
        self.wo = _param(dense_init((nq * hd, d), scale=1.0 / (2 * cfg.n_layers) ** 0.5,
                                    **init))


def init_attn(cfg: ModelConfig, dtype, generator: torch.Generator, device=None) -> Attention:
    return Attention(cfg, dtype, generator, device)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    nq, nkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = _split_heads(x @ p.wq, nq, hd)  # (B,S,nq,hd)
    k = _split_heads(x @ p.wk, nkv, hd)
    v = _split_heads(x @ p.wv, nkv, hd)
    # group q heads by kv head: (B,S,K,G,D)
    B, S = x.shape[:2]
    q = q.reshape(B, S, nkv, nq // nkv, hd)
    return q, k, v


def attn_forward(
    p: Attention,
    x: torch.Tensor,  # (B,S,d)
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,  # (B,S)
    segment_ids: Optional[torch.Tensor] = None,  # (B,S)
    q_offset: int = 0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention; returns (out, (k, v)) for cache priming.
    ``segment_ids`` (packed sequences) keep each query to its own
    segment's keys.  The attention is ``kernels.prefill_attention``'s
    ``attend``: its plain ``flash_attention`` on the CPU, one kernel launch
    on the card (under autograd too, with the plain version's gradient)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if cfg.use_rope:
        if positions is None:
            positions = q_offset + torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q.reshape(B, S, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
        q = q.reshape(B, S, cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.hd)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attend(
        q, k, v, causal=causal, window=window, logit_cap=cfg.attn_softcap,
        q_offset=q_offset, segment_q=segment_ids, segment_k=segment_ids,
        p_bf16=cfg.attn_p_bf16,
    )
    out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo
    return out, (k, v)


def attn_decode(
    p: Attention,
    x: torch.Tensor,  # (B,1,d)
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],  # {"k": (B,T,K,D), "v": (B,T,K,D)}
    pos: torch.Tensor,  # (B,) current absolute position (== kv_len)
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode; writes the new K/V into the cache at ``pos`` (a ring
    for windows) IN PLACE and returns the same cache tensors.

    A slot past the end of the cache (``pos >= T``: an idle slot that keeps
    decoding after its sequence was evicted) is dropped, as the reference's
    ``mode="drop"`` scatter drops it: the row keeps its old K/V.  The
    append and the attention are ``kernels.decode_attention``'s
    ``append_and_attend``: its plain version on the CPU, one kernel launch
    on the card; neither needs a host sync."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q.reshape(B, 1, cfg.n_heads, cfg.hd), pos[:, None], cfg.rope_theta)
        q = q.reshape(B, 1, cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.hd)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    out = append_and_attend(q, k[:, 0], v[:, 0], kc, vc, pos, window=window,
                            logit_cap=cfg.attn_softcap)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p.wo
    return out, {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------


def init_cross_attn(cfg: ModelConfig, dtype, generator: torch.Generator,
                    device=None) -> Attention:
    return Attention(cfg, dtype, generator, device)


def cross_attn_forward(
    p: Attention,
    x: torch.Tensor,  # (B,S,d) decoder states
    enc_kv: Tuple[torch.Tensor, torch.Tensor],  # precomputed (k, v): (B,T,K,D)
    cfg: ModelConfig,
) -> torch.Tensor:
    """Decoder queries against the encoder's K/V, unmasked
    (``kernels.prefill_attention.attend``); decode runs it with S = 1."""
    B, S, _ = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = _split_heads(x @ p.wq, nq, hd).reshape(B, S, nkv, nq // nkv, hd)
    k, v = enc_kv
    out = attend(q, k, v, causal=False, logit_cap=cfg.attn_softcap)
    return out.reshape(B, S, nq * hd) @ p.wo


def cross_kv(p: Attention, enc_out: torch.Tensor,
             cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of the encoder output, computed once per prefill."""
    k = _split_heads(enc_out @ p.wk, cfg.n_kv, cfg.hd)
    v = _split_heads(enc_out @ p.wv, cfg.n_kv, cfg.hd)
    return k, v
