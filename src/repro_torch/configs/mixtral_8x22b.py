"""mixtral-8x22b [moe]: 56L d6144 48H (GQA kv=8) d_ff 16384 vocab 32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="lm",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=16384,
    vocab=32768,
    moe_experts=8,
    moe_topk=2,
    window=4096,  # SWA per assignment spec
    act="swiglu",
    microbatch=16,
    source="arXiv:2401.04088",
    verified="hf",
))
