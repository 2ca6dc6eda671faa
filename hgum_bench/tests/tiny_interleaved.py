"""A reference family for the CPU tests (``families/tiny_interleaved.py``
in a test tree): the default decoder with top-k MoE on some layers only
and dense SwiGLU on the rest, placed as Jamba's config.json places them:
layer ``i`` is MoE where ``i % expert_layer_period ==
expert_layer_offset``, with ``num_experts`` experts.  The default family
cannot express that plan; the program can (``moe_every``, ``moe_offset``).

The forward is made of ``reference/model.py``'s own pieces.  Like every
family, this file imports nothing of the program and nothing of JAX."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from hgum_bench.flops import attention_flops
from hgum_bench.reference import weights
from hgum_bench.reference.model import _attention, _mm, _moe, _rms, _rope


def dims(config: dict) -> dict:
    return dict(weights.dims(config), E=config["num_experts"], k=config["num_experts_per_tok"],
                every=config["expert_layer_period"], offset=config["expert_layer_offset"])


def is_moe(m: dict, layer: int) -> bool:
    return layer % m["every"] == m["offset"]


def spec(config: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """The default decoder's leaves, ``moe.*`` on the MoE layers and
    ``ffn.*`` on the others."""
    m = dims(config)
    d, hd, nq, nkv, ff, L, E = m["d"], m["hd"], m["nq"], m["nkv"], m["ff"], m["L"], m["E"]
    dt = config["torch_dtype"]
    out_scale = 1.0 / math.sqrt(2 * L)
    out = [("embed", (m["Vp"], d), dt, 0.02)]
    for i in range(L):
        p = f"layers.{i}."
        out += [(p + "ln1.scale", (d,), dt, 0.0),
                (p + "attn.wq", (d, nq * hd), dt, d ** -0.5),
                (p + "attn.wk", (d, nkv * hd), dt, d ** -0.5),
                (p + "attn.wv", (d, nkv * hd), dt, d ** -0.5),
                (p + "attn.wo", (nq * hd, d), dt, (nq * hd) ** -0.5 * out_scale),
                (p + "ln2.scale", (d,), dt, 0.0)]
        if is_moe(m, i):
            out += [(p + "moe.router", (d, E), "float32", d ** -0.5),
                    (p + "moe.wi", (E, d, ff), dt, d ** -0.5),
                    (p + "moe.wo", (E, ff, d), dt, ff ** -0.5 * out_scale),
                    (p + "moe.wg", (E, d, ff), dt, d ** -0.5)]
        else:
            out += [(p + "ffn.wi", (d, ff), dt, d ** -0.5),
                    (p + "ffn.wo", (ff, d), dt, ff ** -0.5 * out_scale),
                    (p + "ffn.wg", (d, ff), dt, d ** -0.5)]
    out.append(("final_norm.scale", (d,), dt, 0.0))
    if not m["tied"]:
        out.append(("lm_head", (d, m["Vp"]), dt, 0.02))
    return out


def forward(W: Dict[str, torch.Tensor], config: dict, tokens: torch.Tensor, out_from: int,
            groups: Optional[Sequence[Tuple[torch.Tensor, int]]] = None,
            quant: Optional[str] = None, block: int = 128) -> torch.Tensor:
    """Float32 logits (B, L - out_from, V), as ``model.forward``: each MoE
    layer drops over capacity in the same ``groups``."""
    m = dims(config)
    B, L = tokens.shape
    nq, nkv, hd, eps = m["nq"], m["nkv"], m["hd"], m["eps"]
    if groups is None:
        raise ValueError("an MoE forward needs the token groups of the program's batches")
    x = W["embed"][tokens].float()
    pos = torch.arange(L, device=tokens.device, dtype=torch.float32)
    freqs = 1.0 / (m["theta"] ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                device=tokens.device) / hd))
    ang = pos[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    window = m["window"] if m["window"] is not None and m["window"] < L else None
    for i in range(m["L"]):
        p = f"layers.{i}."
        w = {n: W[p + n].float() for n in ("attn.wq", "attn.wk", "attn.wv", "attn.wo")}
        h = _rms(x, W[p + "ln1.scale"], eps)
        q = _rope(_mm(h, w["attn.wq"], quant).view(B, L, nq, hd), cos, sin)
        kk = _rope(_mm(h, w["attn.wk"], quant).view(B, L, nkv, hd), cos, sin)
        vv = _mm(h, w["attn.wv"], quant).view(B, L, nkv, hd)
        a = _attention(q, kk, vv, window, block).reshape(B, L, nq * hd)
        x = x + _mm(a, w["attn.wo"], quant)
        h = _rms(x, W[p + "ln2.scale"], eps)
        if is_moe(m, i):
            x = x + _moe(h.reshape(B * L, -1), W, p, m, groups, quant).view(B, L, -1)
        else:
            wi, wg, wo = (W[p + n].float() for n in ("ffn.wi", "ffn.wg", "ffn.wo"))
            x = x + _mm(torch.nn.functional.silu(_mm(h, wg, quant)) * _mm(h, wi, quant),
                        wo, quant)
    h = _rms(x[:, out_from:], W["final_norm.scale"], eps)
    head = W["embed"].float().T if m["tied"] else W["lm_head"].float()
    return _mm(h, head, quant)[..., :m["V"]]


def sequence_flops(config: dict, prompt_len: int, generated: int) -> float:
    """``flops.sequence_flops``'s count, each layer by its own kind."""
    m = dims(config)
    d, nq, nkv, hd, ff, E, k = m["d"], m["nq"], m["nkv"], m["hd"], m["ff"], m["E"], m["k"]
    attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    per_token = sum(attn + (k * 3 * d * ff + d * E if is_moe(m, i) else 3 * d * ff)
                    for i in range(m["L"]))
    n = prompt_len + generated - 1
    return n * 2.0 * per_token + attention_flops(config, n) + 2.0 * d * m["V"] * generated


def program_overrides(config: dict) -> dict:
    m = dims(config)
    return dict(weights.decoder_overrides(config), moe_experts=m["E"], moe_topk=m["k"],
                capacity_factor=m["cf"], moe_dff=None, moe_every=m["every"],
                moe_offset=m["offset"])
