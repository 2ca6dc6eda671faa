"""granite-34b [dense]: 88L d6144 48H (MQA kv=1) d_ff 24576 vocab 49152.

Llama-architecture code model with multi-query attention.
[arXiv:2405.04324; hf]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b",
    family="lm",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv=1,
    d_ff=24576,
    vocab=49152,
    act="gelu",  # gpt-bigcode 2-matrix MLP (GLU would be ~46B, not 34B)
    microbatch=32,
    source="arXiv:2405.04324",
    verified="hf",
))
