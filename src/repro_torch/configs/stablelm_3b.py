"""stablelm-3b [dense]: 32L d2560 32H (MHA kv=32) d_ff 6912 vocab 50304.

[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    family="lm",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=6912,
    vocab=50304,
    act="swiglu",
    microbatch=8,
    source="hf:stabilityai/stablelm-2-1_6b",
    verified="unverified",
))
