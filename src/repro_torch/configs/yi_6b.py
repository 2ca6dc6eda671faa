"""yi-6b [dense]: 32L d4096 32H (GQA kv=4) d_ff 11008 vocab 64000.

Llama-architecture GQA.  [arXiv:2403.04652; hf]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-6b",
    family="lm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    d_ff=11008,
    vocab=64000,
    act="swiglu",
    microbatch=4,
    source="arXiv:2403.04652",
    verified="hf",
))
