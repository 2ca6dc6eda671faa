"""Optimizer substrate: AdamW with fp32 master weights, schedules, clipping,
and gradient-accumulation microbatching (counterpart of ``repro.optim``)."""
from .adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from .schedule import cosine_schedule, linear_warmup_cosine
from .microbatch import microbatched_grads

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm", "cosine_schedule",
    "linear_warmup_cosine", "microbatched_grads",
]
