"""The model families in torch: lm, vlm and encdec (counterpart of ``repro.models``)."""
from .model import (
    LM,
    by_ref_path,
    cache_zeros,
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_plan,
    loss_fn,
    opt_state_from_jax,
    param_count,
    params_from_jax,
    plan_period,
    prefill,
    stack_layers,
)

__all__ = [
    "LM", "by_ref_path", "cache_zeros", "decode_step", "forward", "init_cache",
    "init_params", "layer_plan", "loss_fn", "opt_state_from_jax", "param_count",
    "params_from_jax", "plan_period", "prefill", "stack_layers",
]
