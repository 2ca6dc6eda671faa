"""Feed-forward layers: dense GLU variants and top-k MoE (plain torch).

Counterpart of ``repro.models.ffn``.  The MoE dispatch is the reference's
*sort-based* one: the (token, slot) pairs are sorted by expert, ranked
within their expert, and scattered into capacity-bounded ``(E, C, d)``
frames; the expert products are batched matmuls over those frames, and
the combine adds each pair's gated output back onto its token.  Tokens go
in groups of ``TOKEN_GROUP``, each with a group-local capacity.

Ties and drops follow the reference exactly:

* ``jax.lax.top_k`` breaks ties toward the lower expert index.  Zero-padded
  rows of the grouped path have all-zero router logits, so a uniform
  softmax, and the reference sends every such row to experts 0, 1, ...;
  ``torch.topk`` promises no order, so the top-k here is a stable
  descending sort cut to its first ``k``.
* The dispatch scatter sends over-capacity pairs to row ``E*C``, which the
  reference drops (``mode="drop"``); here the frame has one trash row past
  the end, sliced off after the scatter, so no host sync decides it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..obs.timeline import count
from ..obs.timeline import current as current_trace
from ..runtime.actshard import constrain as act_constrain
from .common import _param, act_fn, dense_init

#: tokens per dispatch group (the reference's default)
TOKEN_GROUP = 8192


class DenseFFN(torch.nn.Module):
    """``wi`` (d, ff), ``wo`` (ff, d), and ``wg`` (d, ff) for GLU acts."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        init = dict(generator=generator, dtype=dtype, device=device)
        self.wi = _param(dense_init((d, ff), **init))
        self.wo = _param(dense_init((ff, d), scale=1.0 / (2 * cfg.n_layers) ** 0.5, **init))
        if cfg.act in ("swiglu", "geglu"):
            self.wg = _param(dense_init((d, ff), **init))
        else:
            self.wg = None


def init_dense_ffn(cfg: ModelConfig, dtype, generator: torch.Generator,
                   device=None) -> DenseFFN:
    return DenseFFN(cfg, dtype, generator, device)


def dense_ffn(p: DenseFFN, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = x @ p.wi
    if p.wg is not None:
        h = act(x @ p.wg) * h
    else:
        h = act(h)
    return h @ p.wo


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


class MoEFFN(torch.nn.Module):
    """``router`` (d, E) in float32 whatever the model's dtype; ``wi``,
    ``wg`` (E, d, ff) and ``wo`` (E, ff, d) in the model's dtype."""

    def __init__(self, cfg: ModelConfig, dtype, generator: torch.Generator, device=None):
        super().__init__()
        d, E = cfg.d_model, cfg.moe_experts
        ff = cfg.moe_dff or cfg.d_ff
        init = dict(generator=generator, device=device)
        self.router = _param(dense_init((d, E), dtype=torch.float32, **init))
        self.wi = _param(dense_init((E, d, ff), in_axis=1, dtype=dtype, **init))
        self.wo = _param(dense_init((E, ff, d), in_axis=1, dtype=dtype,
                                    scale=1.0 / (2 * cfg.n_layers) ** 0.5, **init))
        if cfg.act in ("swiglu", "geglu"):
            self.wg = _param(dense_init((E, d, ff), in_axis=1, dtype=dtype, **init))
        else:
            self.wg = None


def init_moe_ffn(cfg: ModelConfig, dtype, generator: torch.Generator,
                 device=None) -> MoEFFN:
    return MoEFFN(cfg, dtype, generator, device)


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    E, k = cfg.moe_experts, cfg.moe_topk
    cap = int(math.ceil(cfg.capacity_factor * n_tokens * k / E))
    return max(8, -(-cap // 8) * 8)  # round up to 8, as the reference tiles


def _moe_group(p: MoEFFN, xf: torch.Tensor, cfg: ModelConfig, C: int, act):
    """Dispatch + experts + combine for one token group.  xf: (G, d)."""
    G, d = xf.shape
    E, topk = cfg.moe_experts, cfg.moe_topk
    dev = xf.device

    logits = xf.float() @ p.router  # (G,E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with lax.top_k's tie order: lower expert index first
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[:, :topk], gate_idx[:, :topk]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # (token, slot) pairs, sorted by expert (stable keeps token order)
    pair_expert = gate_idx.reshape(-1)
    pair_token = torch.arange(G, device=dev).repeat_interleave(topk)
    pair_gate = gate_vals.reshape(-1)
    order = torch.argsort(pair_expert, stable=True)
    se, st, sg = pair_expert[order], pair_token[order], pair_gate[order]
    # jnp.bincount(length=E); torch.bincount would read max(se) on the host
    counts = torch.zeros(E, dtype=se.dtype, device=dev).scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(G * topk, device=dev) - starts[se]
    keep = rank < C
    trace = current_trace()
    if trace is not None:  # (token, slot) pairs routed, and those over capacity
        count(trace, "moe.routed", keep.numel())
        count(trace, "moe.dropped", keep.numel() - keep.sum())

    # pack into per-expert frames; over-capacity pairs land in the trash
    # row E*C, which is cut off (the reference drops them)
    dest = torch.where(keep, se * C + rank, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=dev)
    buf[dest] = xf[st]
    buf = buf[: E * C].reshape(E, C, d)

    h = torch.bmm(buf, p.wi)  # einsum("ecd,edf->ecf")
    if p.wg is not None:
        h = act(torch.bmm(buf, p.wg)) * h
    else:
        h = act(h)
    out_buf = torch.bmm(h, p.wo).reshape(E * C, d)

    src = torch.where(keep, se * C + rank, 0)
    pair_out = out_buf[src] * (sg * keep).to(xf.dtype)[:, None]
    # the reference's .at[st].add: with top-2 every row receives two addends
    # onto zero, and a + b == b + a, so the order of the adds cannot change
    # the sum
    yf = torch.zeros((G, d), dtype=xf.dtype, device=dev).index_add_(0, st, pair_out)

    frac_tokens = counts.float() / max(G * topk, 1)
    balance = cfg.moe_experts * torch.sum(frac_tokens * probs.mean(dim=0))
    return yf, balance, 1.0 - keep.float().mean()


def moe_ffn(
    p: MoEFFN, x: torch.Tensor, cfg: ModelConfig, capacity: Optional[int] = None,
    token_group: int = TOKEN_GROUP,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k capacity-bounded MoE over token groups (see module docstring).

    Capacity counts every row of ``x``: the padding rows of a prefill and
    the idle slots of a decode step take expert capacity as live rows do."""
    B, S, d = x.shape
    T = B * S
    act = act_fn(cfg.act)
    xf = x.reshape(T, d)

    if T <= token_group:
        C = capacity or moe_capacity(cfg, T)
        yf, balance, dropped = _moe_group(p, xf, cfg, C, act)
        return yf.reshape(B, S, d), {"moe_balance_loss": balance, "moe_dropped": dropped}

    # zero-pad to whole groups; each group dispatches with its own capacity
    n_groups = -(-T // token_group)
    pad = n_groups * token_group - T
    xg = torch.nn.functional.pad(xf, (0, 0, 0, pad)).reshape(n_groups, token_group, d)
    C = capacity or moe_capacity(cfg, token_group)
    ys, bal, drp = [], [], []
    for i in range(n_groups):  # the reference's lax.scan over groups
        yf, balance, dropped = _moe_group(p, xg[i], cfg, C, act)
        ys.append(yf)
        bal.append(balance)
        drp.append(dropped)
    yf = act_constrain(torch.cat(ys)[:T], "tokens_flat")
    return yf.reshape(B, S, d), {
        "moe_balance_loss": torch.stack(bal).mean(),
        "moe_dropped": torch.stack(drp).mean(),
    }
