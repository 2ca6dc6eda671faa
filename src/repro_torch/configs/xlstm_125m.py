"""xlstm-125m [ssm]: 12L d768 4H d_ff=0 vocab 50304.

Alternating mLSTM (matrix memory) and sLSTM (scalar memory, exponential
gating) blocks; no FFN (d_ff=0).  [arXiv:2405.04517; unverified]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="lm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    layer_pattern="xlstm",
    ssm_expand=2,
    ssm_head=192,  # d_inner(1536) / 8 heads -> use 4 heads of 384? keep 192x8
    act="gelu",
    use_rope=False,
    microbatch=1,
    source="arXiv:2405.04517",
    verified="unverified",
))
