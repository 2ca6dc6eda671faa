"""The ``lm`` model family in torch (counterpart of ``repro.models``)."""
from .model import (
    LM,
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_plan,
    param_count,
    params_from_jax,
    prefill,
)
