"""The model families in torch: lm, vlm and encdec (counterpart of ``repro.models``)."""
from .model import (
    LM,
    cache_zeros,
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_plan,
    param_count,
    params_from_jax,
    plan_period,
    prefill,
    stack_layers,
)

__all__ = [
    "LM", "cache_zeros", "decode_step", "forward", "init_cache", "init_params",
    "layer_plan", "param_count", "params_from_jax", "plan_period", "prefill",
    "stack_layers",
]
