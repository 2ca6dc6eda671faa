"""Serving step functions (prefill / decode), greedy and eager.

Counterpart of the serving half of ``repro.launch.steps``.  PyTorch runs
eagerly, so there is nothing to trace: ``cached_serve_steps`` memoizes the
step closures on (cfg, cache_len, logprobs) only so the scheduler can
re-enter the same functions every tick, as the reference re-enters its
jitted ones.  With ``logprobs=True`` the steps also return the chosen
token's float32 log-probability (the typed logprob stream's payload).
The steps serve every model family: a vlm's or encdec's batch carries its
``vision`` or ``audio`` input beside the tokens
(``runtime.scheduler.extra_inputs``).  Training steps and input specs are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.model import LM, decode_step, prefill


def _greedy_with_logprob(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy pick + the chosen token's log-probability.

    The argmax is computed exactly as in the logprob-free path, so
    enabling logprobs can never change which token is served; the
    log-softmax runs in float32."""
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = torch.gather(logp, -1, next_tok[..., None].long())[..., 0]
    return next_tok, tok_lp


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None,
                      logprobs: bool = False):
    @torch.no_grad()
    def prefill_step(params: LM, batch: Dict[str, torch.Tensor]):
        # last_only: serving prefill needs next-token logits, not (B, S, V)
        logits, cache = prefill(params, cfg, batch, cache_len=cache_len, last_only=True)
        # the first token comes from the last (padded) position
        if logprobs:
            next_tok, tok_lp = _greedy_with_logprob(logits[:, -1:])
            return next_tok, tok_lp, cache
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, logprobs: bool = False):
    @torch.no_grad()
    def serve_step(params: LM, cache: Dict, tokens: torch.Tensor):
        logits, cache = decode_step(params, cfg, cache, tokens)
        if logprobs:
            next_tok, tok_lp = _greedy_with_logprob(logits)
            return next_tok, tok_lp, cache
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step


_SERVE_STEP_CACHE: Dict[Tuple, Tuple] = {}


def cached_serve_steps(cfg: ModelConfig, cache_len: int, logprobs: bool = False):
    """(prefill_step, serve_step) memoized on (cfg, cache_len, logprobs)."""
    key = (cfg, cache_len, logprobs)
    if key not in _SERVE_STEP_CACHE:
        _SERVE_STEP_CACHE[key] = (
            make_prefill_step(cfg, cache_len=cache_len, logprobs=logprobs),
            make_serve_step(cfg, logprobs=logprobs),
        )
    return _SERVE_STEP_CACHE[key]


def clear_serve_step_cache() -> None:
    _SERVE_STEP_CACHE.clear()
