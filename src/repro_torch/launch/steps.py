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
default).

The input specs (:func:`input_specs` and its parts) stand in for the
reference's ``ShapeDtypeStruct``s: tensors on the ``meta`` device, with
shapes and dtypes and no storage, so the dry run sizes a 398 B-parameter
model on any host.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import LM, decode_step, init_cache, init_params, loss_fn, prefill
from ..obs.timeline import current as current_trace
from ..obs.timeline import span
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update, microbatched_grads
from ..runtime.sharding import with_sharding_constraint



def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, lr_fn=None,
                    grad_shardings=None, micro_sharding_fn=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``cfg.microbatch`` microbatches of :func:`loss_fn`, then one
    AdamW step at ``lr_fn(opt_state.step)``.  The parameters are updated in
    place.  ``grad_shardings`` (one ``runtime.sharding.NamedSharding`` per
    parameter name) constrains the grads, ``micro_sharding_fn`` the
    ``(n_micro, b / n_micro, ...)`` microbatches, as in the reference; on
    one card both check their specs and change no value."""
    lr_fn = lr_fn or (lambda step: opt_cfg.lr)
    if grad_shardings is not None:
        constrain = lambda g: with_sharding_constraint(g, grad_shardings)  # noqa: E731
    else:
        constrain = lambda g: g  # noqa: E731
    constrain_micro = micro_sharding_fn or (lambda b: b)

    def train_step(params: LM, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        loss, grads, metrics = microbatched_grads(
            lambda p, b: loss_fn(p, cfg, b), params, batch, cfg.microbatch,
            constrain=constrain, constrain_micro=constrain_micro)
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
        with span(current_trace(), "model.argmax"):
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
        with span(current_trace(), "model.argmax"):
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


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins; no allocation — dry-run food)
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def batch_specs(cfg: ModelConfig, B: int, S: int, kind: str) -> Dict[str, torch.Tensor]:
    """Specs for the batch dict of a train/prefill step."""
    f32, i32 = torch.float32, torch.int32
    specs = {"tokens": _sds((B, S), i32)}
    if kind == "train":
        specs["labels"] = _sds((B, S), i32)
        specs["loss_mask"] = _sds((B, S), f32)
        specs["segment_ids"] = _sds((B, S), i32)
        specs["positions"] = _sds((B, S), i32)
    if cfg.family == "vlm":
        specs["vision"] = _sds((B, cfg.vision_tokens, cfg.vision_dim), f32)
    if cfg.family == "encdec":
        specs["audio"] = _sds((B, cfg.enc_seq, cfg.d_model), f32)
    return specs


def params_specs(cfg: ModelConfig) -> LM:
    return init_params(cfg, device=_META)


def opt_specs(cfg: ModelConfig) -> OptState:
    return adamw_init(params_specs(cfg), cfg.opt_moments)


def cache_specs(cfg: ModelConfig, B: int, cache_len: int) -> Dict:
    return init_cache(cfg, B, cache_len, device=_META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All inputs a dry-run cell runs against, keyed by step argument."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {
            "params": params_specs(cfg),
            "opt_state": opt_specs(cfg),
            "batch": batch_specs(cfg, B, S, "train"),
        }
    if shape.kind == "prefill":
        return {
            "params": params_specs(cfg),
            "batch": batch_specs(cfg, B, S, "prefill"),
        }
    # decode: one new token against a seq_len cache
    return {
        "params": params_specs(cfg),
        "cache": cache_specs(cfg, B, S),
        "tokens": _sds((B, 1), torch.int32),
    }
