"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) d_ff 24576
vocab 65536, MoE 16e top-2.  Mamba+attention 1:7 interleave, MoE every
other layer.  [arXiv:2403.19887; hf]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="lm",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=24576,
    vocab=65536,
    layer_pattern="jamba",
    moe_experts=16,
    moe_topk=2,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head=64,
    act="swiglu",
    use_rope=False,  # jamba uses no positional encoding (mamba carries order)
    microbatch=64,
    opt_moments="q8",  # 398B: fp32 moments alone exceed 16 GiB/chip at 512 chips
    source="arXiv:2403.19887",
    verified="hf",
))
