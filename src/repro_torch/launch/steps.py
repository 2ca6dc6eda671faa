"""Serving step functions (prefill / decode), greedy and eager.

Counterpart of the serving half of ``repro.launch.steps``.  PyTorch runs
eagerly, so there is nothing to trace: ``cached_serve_steps`` memoizes the
step closures on (cfg, cache_len) only so the scheduler can re-enter the
same functions every tick, as the reference re-enters its jitted ones.
Training steps and input specs are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.model import LM, decode_step, prefill


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None):
    @torch.no_grad()
    def prefill_step(params: LM, batch: Dict[str, torch.Tensor]):
        # last_only: serving prefill needs next-token logits, not (B, S, V)
        logits, cache = prefill(params, cfg, batch, cache_len=cache_len, last_only=True)
        # the first token comes from the last (padded) position
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params: LM, cache: Dict, tokens: torch.Tensor):
        logits, cache = decode_step(params, cfg, cache, tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step


_SERVE_STEP_CACHE: Dict[Tuple, Tuple] = {}


def cached_serve_steps(cfg: ModelConfig, cache_len: int):
    """(prefill_step, serve_step) memoized on (cfg, cache_len)."""
    key = (cfg, cache_len)
    if key not in _SERVE_STEP_CACHE:
        _SERVE_STEP_CACHE[key] = (
            make_prefill_step(cfg, cache_len=cache_len),
            make_serve_step(cfg),
        )
    return _SERVE_STEP_CACHE[key]


def clear_serve_step_cache() -> None:
    _SERVE_STEP_CACHE.clear()
