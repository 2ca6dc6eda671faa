"""Step functions (train / prefill / decode), eager.

Counterpart of ``repro.launch.steps``.  PyTorch runs eagerly, so there is
nothing to trace: ``cached_serve_steps`` memoizes the serving step
closures on (cfg, cache_len, logprobs) only so the scheduler can re-enter
the same functions every tick, as the reference re-enters its jitted
ones.  With ``logprobs=True`` the serving steps also return the chosen
token's float32 log-probability (the typed logprob stream's payload).
The steps serve every model family: a vlm's or encdec's batch carries its
``vision`` or ``audio`` input beside the tokens
(``runtime.scheduler.extra_inputs``).  The train step runs where the
model's parameters live (``init_params`` puts them on the card by
default).  The ShapeDtypeStruct input specs of the reference belong to
the multi-device drivers (ROADMAP.md queue A item 14).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.model import LM, decode_step, loss_fn, prefill
from ..optim import AdamWConfig, OptState, adamw_update, microbatched_grads

_MESH_TODO = "ROADMAP.md queue A item 14 (multi-device drivers)"


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, lr_fn=None,
                    grad_shardings=None, micro_sharding_fn=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``cfg.microbatch`` microbatches of :func:`loss_fn`, then one
    AdamW step at ``lr_fn(opt_state.step)``.  The parameters are updated in
    place.  The reference's mesh arguments take ``None`` only."""
    if grad_shardings is not None or micro_sharding_fn is not None:
        raise NotImplementedError(f"grad_shardings / micro_sharding_fn need a mesh: "
                                  f"{_MESH_TODO}")
    lr_fn = lr_fn or (lambda step: opt_cfg.lr)

    def train_step(params: LM, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        loss, grads, metrics = microbatched_grads(
            lambda p, b: loss_fn(p, cfg, b), params, batch, cfg.microbatch)
        lr = lr_fn(opt_state.step)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg, lr)
        metrics.update(opt_metrics)
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


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
