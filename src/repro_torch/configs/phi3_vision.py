"""phi-3-vision-4.2b [vlm]: 32L d3072 32H (MHA kv=32) d_ff 8192 vocab 32064.

phi3-mini backbone + CLIP frontend STUB: ``input_specs()`` provides
precomputed patch embeddings (B, 576, 1024), projected into d_model and
prepended to the token embeddings.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32064,
    vision_tokens=576,
    vision_dim=1024,
    act="swiglu",
    microbatch=4,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    verified="hf",
))
