"""Shared model components in plain torch: norms, RoPE, initializers,
attention, the loss.

Counterpart of ``repro.models.common``.  Parameters keep the reference's
layout (``x @ W`` with ``W`` shaped ``(d_in, d_out)``), and the numerics
follow it where they matter for parity: norms, RoPE angles, attention
scores and ``p @ v`` in float32 (``p`` in bf16 where the config asks),
the loss's logsumexp in float32, cast back to the working dtype after.
Initialization draws from an explicit ``torch.Generator``; it does not
reproduce the reference's JAX random bits (use
``models.model.params_from_jax`` to carry reference weights over).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

# the plain attentions and softcap, re-exported: they live beside their kernels
from ..kernels.decode_attention import decode_attention  # noqa: F401
from ..kernels.prefill_attention import NEG_INF, flash_attention, softcap  # noqa: F401

# ---------------------------------------------------------------------------
# dtype / init helpers
# ---------------------------------------------------------------------------


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def dense_init(shape, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.float32, scale: float = 1.0,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (stddev = scale/sqrt(fan_in))."""
    std = scale / math.sqrt(shape[in_axis])
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)  # in place: no second float32 copy of a large stack


def embed_init(shape, generator: torch.Generator, dtype=torch.float32,
               device=None) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.normal_(t, 0.0, 1.0, generator=generator)
    return t.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def apply_norm(kind: str, p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """``p`` is a :class:`Norm` module (``scale``, and ``bias`` for layernorm)."""
    if kind == "rmsnorm":
        return rmsnorm(x, p.scale, eps)
    return layernorm(x, p.scale, p.bias, eps)


class Norm(torch.nn.Module):
    """Norm parameters: ``scale`` (rmsnorm; applied as ``1 + scale``, so it
    starts at zero) or ``scale`` and ``bias`` (layernorm)."""

    def __init__(self, kind: str, d: int, dtype, device=None):
        super().__init__()
        if kind == "rmsnorm":
            self.scale = _param(torch.zeros(d, dtype=dtype, device=device))
        else:
            self.scale = _param(torch.ones(d, dtype=dtype, device=device))
            self.bias = _param(torch.zeros(d, dtype=dtype, device=device))


def init_norm(kind: str, d: int, dtype, device=None) -> Norm:
    return Norm(kind, d, dtype, device)


def path_parts(name: str) -> Tuple:
    """A parameter name as the reference pytree's path: dict keys, and
    list indices as ints (``layers.0.attn.wq`` -> ``('layers', 0, 'attn',
    'wq')``).  Sorting names by it gives the reference's flatten order."""
    return tuple(int(x) if x.isdigit() else x for x in name.split("."))


def keystr(parts: Tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]" for p in parts)


def _param(t: torch.Tensor) -> torch.nn.Parameter:
    """A parameter built without ``requires_grad``: serving takes no
    gradients; ``optim.microbatched_grads`` turns them on for the model it
    trains."""
    return torch.nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int.  Split-half rotation."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    ang = positions[..., :, None, None].float() * freqs  # (...,S,1,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def act_fn(name: str):
    return {
        "gelu": _gelu_tanh,
        "silu": F.silu,
        "swiglu": F.silu,  # gate activation for GLU variants
        "geglu": _gelu_tanh,
        "relu": F.relu,
    }[name]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V)
    targets: torch.Tensor,  # (B, S) int
    mask: Optional[torch.Tensor] = None,  # (B, S) 0/1
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked mean next-token NLL with the reference's z-loss
    (``z_loss * logsumexp**2`` per position), all in float32; metrics
    ``loss``, ``accuracy`` (argmax == target, masked mean) and ``tokens``
    (the mask's sum)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse**2
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == targets.long()) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": mask.sum().detach()}
