"""Plain float32 forward of the served decoder: dense GQA attention with
RoPE, SwiGLU, and a top-k MoE with the program's capacity rule.

It follows the published Llama/Mixtral block (pre-norm RMSNorm, RoPE
rotating the two halves of each head, SwiGLU ``silu(x Wg) * (x Wi) Wo``,
a softmax router whose top-k gates are renormalised) with no cache, no
batching across requests and no kernels: every position of every
sequence is computed from its tokens.  Departures, as the program runs:

* prompts are right-padded with token 0 to ``pad_to`` and not masked, so
  the first served token is predicted at position ``pad_to - 1``;
* an MoE layer drops (token, expert) pairs over capacity.  Tokens go in
  the groups the program's batches form (``groups``), each with its own
  capacity; within an expert, pairs rank in (token, slot) order and the
  first ``C`` are kept (``moe_capacity``).

``quant="fp8"`` is the control: every matrix product takes its operands
through float8 e4m3 (per output column for weights, per row for
activations), the step below the configuration's bfloat16.

Matrix products run in float32 with TF32 off (the caller sets it).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .weights import dims

FP8_MAX = 448.0


def moe_capacity(n_tokens: int, E: int, k: int, cf: float) -> int:
    """Pairs one expert keeps in a group of ``n_tokens``: ``ceil(cf * n *
    k / E)`` rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(cf * n_tokens * k / E))
    return max(8, -(-cap // 8) * 8)


def _fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        return _fake_fp8(a, -1) @ _fake_fp8(w, -2)
    return a @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, window: Optional[int], block: int) -> torch.Tensor:
    """Causal attention; q (B, L, nq, hd), k/v (B, L, nkv, hd)."""
    B, L, nq, hd = q.shape
    g = nq // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)  # (B, nq, L, hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    kpos = torch.arange(L, device=q.device)
    out = torch.empty_like(q)
    for a in range(0, L, block):
        qpos = kpos[a:a + block]
        s = (q[:, :, a:a + block] @ k.transpose(-1, -2)) / math.sqrt(hd)
        ok = kpos[None, :] <= qpos[:, None]
        if window is not None:
            ok = ok & (qpos[:, None] - kpos[None, :] < window)
        s = s.masked_fill(~ok, float("-inf"))
        out[:, :, a:a + block] = torch.softmax(s, dim=-1) @ v
    return out.transpose(1, 2)


def _moe(h: torch.Tensor, W: Dict[str, torch.Tensor], p: str, m: dict,
         groups: Sequence[Tuple[torch.Tensor, int]], quant: Optional[str]) -> torch.Tensor:
    """Top-k MoE over flat tokens ``h`` (N, d); ``groups`` are (token
    indices, capacity) pairs that cover every token once."""
    E, k = m["E"], m["k"]
    probs = torch.softmax(h @ W[p + "moe.router"].float(), dim=-1)
    gv, gi = torch.sort(probs, dim=-1, descending=True, stable=True)
    gv, gi = gv[:, :k], gi[:, :k]
    gv = gv / gv.sum(-1, keepdim=True).clamp(min=1e-9)
    chosen: List[List[torch.Tensor]] = [[] for _ in range(E)]
    for idx, cap in groups:
        pairs = gi[idx].reshape(-1)  # (token, slot) order within the group
        for e in range(E):
            sel = (pairs == e).nonzero()[:, 0][:cap]  # the first cap pairs
            chosen[e].append(torch.stack([idx[sel // k], sel % k]))
    out = torch.zeros_like(h)
    for e in range(E):
        if not chosen[e]:
            continue
        tok, slot = torch.cat(chosen[e], dim=1)
        if not tok.numel():
            continue
        x = h[tok]
        wi, wg, wo = (W[p + n][e].float() for n in ("moe.wi", "moe.wg", "moe.wo"))
        y = _mm(torch.nn.functional.silu(_mm(x, wg, quant)) * _mm(x, wi, quant), wo, quant)
        out.index_add_(0, tok, y * gv[tok, slot][:, None])
    return out


def forward(W: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor, out_from: int,
            groups: Optional[Sequence[Tuple[torch.Tensor, int]]] = None,
            quant: Optional[str] = None, block: int = 128) -> torch.Tensor:
    """Float32 logits (B, L - out_from, V) of ``tokens`` (B, L) at
    positions ``out_from`` .. L-1.  ``groups`` index the flat (B * L)
    tokens; an MoE configuration needs them."""
    m = dims(cfg)
    B, L = tokens.shape
    nq, nkv, hd, eps = m["nq"], m["nkv"], m["hd"], m["eps"]
    if m["E"] and groups is None:
        raise ValueError("an MoE forward needs the token groups of the program's batches")
    x = W["embed"][tokens].float()
    pos = torch.arange(L, device=tokens.device, dtype=torch.float32)
    freqs = 1.0 / (m["theta"] ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                device=tokens.device) / hd))
    ang = pos[:, None] * freqs  # (L, hd/2)
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
        del q, kk, vv, a, w
        h = _rms(x, W[p + "ln2.scale"], eps)
        if m["E"]:
            x = x + _moe(h.reshape(B * L, -1), W, p, m, groups, quant).view(B, L, -1)
        else:
            wi, wg, wo = (W[p + n].float() for n in ("ffn.wi", "ffn.wg", "ffn.wo"))
            x = x + _mm(torch.nn.functional.silu(_mm(h, wg, quant)) * _mm(h, wi, quant),
                        wo, quant)
            del wi, wg, wo
        del h
    h = _rms(x[:, out_from:], W["final_norm.scale"], eps)
    head = W["embed"].float().T if m["tied"] else W["lm_head"].float()
    return _mm(h, head, quant)[..., :m["V"]]
