"""gemma2-27b [dense]: 46L d4608 32H (GQA kv=16) d_ff 36864 vocab 256000.

Local+global alternating attention (window 4096 on local layers), logit
softcapping (attn 50.0, final 30.0), GeGLU.  [arXiv:2408.00118; hf]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b",
    family="lm",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    window=4096,
    local_global_alternate=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    sandwich_norm=True,
    act="geglu",
    microbatch=16,
    source="arXiv:2408.00118",
    verified="hf",
))
