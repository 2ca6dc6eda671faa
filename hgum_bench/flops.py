"""Model FLOPs of useful work, from the configuration file alone.

Frozen here so that the count reads the same work whatever implements it.
A served sequence of ``P`` prompt tokens (padding not counted) and ``G``
generated tokens runs ``N = P + G - 1`` tokens through the layers (the
last generated token is never fed back) and the head ``G`` times.  Per
token and layer a matrix product of ``a x b`` weights costs ``2ab``; the
attention of a token at position ``t`` costs ``4 * nq * hd * c`` for its
true context ``c = min(t + 1, window)``; an MoE layer counts its router
and its top-k experts.  Embedding lookups, norms and softmaxes are not
counted.
"""
from __future__ import annotations

from .reference.weights import dims

#: NVIDIA H100 SXM, dense bfloat16 (data sheet), at its 700 W limit
PEAK_BF16_FLOPS = 989e12


def token_matmul_flops(cfg: dict) -> float:
    """Weight FLOPs of one token through every layer (head excluded)."""
    m = dims(cfg)
    d, nq, nkv, hd, ff = m["d"], m["nq"], m["nkv"], m["hd"], m["ff"]
    attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    ffn = m["k"] * 3 * d * ff + d * m["E"] if m["E"] else 3 * d * ff
    return 2.0 * m["L"] * (attn + ffn)


def attention_flops(cfg: dict, n_tokens: int) -> float:
    """Score and value FLOPs of positions ``0 .. n_tokens - 1`` of one
    causal sequence, every layer."""
    m = dims(cfg)
    w = m["window"]
    if w is None or w >= n_tokens:
        ctx = n_tokens * (n_tokens + 1) // 2
    else:
        ctx = w * (w + 1) // 2 + (n_tokens - w) * w
    return 4.0 * m["nq"] * m["hd"] * ctx * m["L"]


def sequence_flops(cfg: dict, prompt_len: int, generated: int) -> float:
    m = dims(cfg)
    n = prompt_len + generated - 1
    head = 2.0 * m["d"] * m["V"] * generated
    return n * token_matmul_flops(cfg) + attention_flops(cfg, n) + head
