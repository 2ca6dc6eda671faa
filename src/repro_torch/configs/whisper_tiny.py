"""whisper-tiny [audio]: 4L d384 6H (kv=6) d_ff 1536 vocab 51865.

Encoder-decoder; conv frontend is a STUB — ``input_specs()`` provides
precomputed frame embeddings (B, enc_seq, d).  [arXiv:2212.04356; unverified]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    use_rope=False,  # whisper uses learned/sinusoidal positions
    tie_embeddings=True,
    microbatch=8,
    source="arXiv:2212.04356",
    verified="unverified",
))
