"""Feed-forward layers: dense GLU variants (plain torch).

Counterpart of the dense path of ``repro.models.ffn``.  The top-k MoE FFN
is not ported yet.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import _param, act_fn, dense_init


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
