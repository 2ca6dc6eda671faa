"""phi3.5-moe-42b-a6.6b [moe]: 32L d4096 32H (GQA kv=8) d_ff 6400
vocab 32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="lm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=6400,
    vocab=32064,
    moe_experts=16,
    moe_topk=2,
    act="swiglu",
    microbatch=16,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    verified="hf",
))
