"""AdamW with fp32 master weights (params may be bf16) and global-norm clip.

Counterpart of ``repro.optim.adamw``, with its arithmetic (not
``torch.optim.AdamW``, whose weight decay and epsilon round otherwise):
bias corrections from a float32 step, ``(mu/c1) / (sqrt(nu/c2) + eps)``,
``m - lr * (delta + wd * m)`` on the float32 master, and parameters cast
back to their own dtype.  The state is a plain dataclass of dicts keyed by
the port's parameter names (``layers.0.attn.wq``), so the HGum checkpoint
layer writes it under the reference's pytree paths.  Leaves are visited
in the reference's flatten order, so the global norm sums in its order.

``params`` is the model (an ``nn.Module``: its parameters are updated in
place and the module is returned) or a dict of named tensors (a new dict
is returned); ``grads`` is a dict keyed by the same names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..models.common import path_parts

Params = Union[torch.nn.Module, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # "fp32": plain moments.  "q8": first moment int8 (blockwise absmax,
    # block 256) + second moment bf16 — 8.06 B/param of optimizer state
    # instead of 12.
    moments: str = "fp32"


Q8_BLOCK = 256


def _q8_encode(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % Q8_BLOCK
    fp = F.pad(flat, (0, pad)).reshape(-1, Q8_BLOCK)
    scale = torch.clamp(fp.abs().amax(dim=1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(fp / scale[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def _q8_decode(enc: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    fp = enc["q"].float() * enc["s"][:, None]
    n = 1
    for d in shape:
        n *= d
    return fp.reshape(-1)[:n].reshape(shape)


@dataclass
class OptState:
    step: torch.Tensor  # scalar int32
    mu: Dict[str, Any]  # first moment (fp32; q8: {"q", "s"} per parameter)
    nu: Dict[str, torch.Tensor]  # second moment (fp32; q8: bf16)
    master: Dict[str, torch.Tensor]  # fp32 master copy of params


def _named(params: Params) -> Dict[str, torch.Tensor]:
    """name -> tensor, in the reference's flatten order."""
    named = (dict(params.named_parameters()) if isinstance(params, torch.nn.Module)
             else dict(params))
    return {n: named[n] for n in sorted(named, key=path_parts)}


def adamw_init(params: Params, moments: str = "fp32") -> OptState:
    named = _named(params)
    with torch.no_grad():
        if moments == "q8":
            mu = {n: _q8_encode(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
                  for n, p in named.items()}
            nu = {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                  for n, p in named.items()}
        else:
            mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
            nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
        # a copy: float32 params must not alias the master
        master = {n: p.detach().to(torch.float32, copy=True) for n, p in named.items()}
    dev = next(iter(named.values())).device if named else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=mu, nu=nu, master=master)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [tree[n] for n in sorted(tree, key=path_parts)]
    return list(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a dict is
    summed in the reference's order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


def clip_by_global_norm(grads: Dict[str, torch.Tensor],
                        max_norm: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(
    grads: Dict[str, torch.Tensor],
    state: OptState,
    params: Params,
    cfg: AdamWConfig,
    lr: torch.Tensor | float,
) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params in their own dtype, state, stats)."""
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - cfg.b1**t
    c2 = 1.0 - cfg.b2**t
    q8 = cfg.moments == "q8"

    mu, nu, master = {}, {}, {}
    for n in sorted(grads, key=path_parts):
        g = grads[n].float()
        if q8:
            mu_f, nu_f = _q8_decode(state.mu[n], g.shape), state.nu[n].float()
        else:
            mu_f, nu_f = state.mu[n], state.nu[n]
        mu_f = cfg.b1 * mu_f + (1 - cfg.b1) * g
        nu_f = cfg.b2 * nu_f + (1 - cfg.b2) * g * g
        delta = (mu_f / c1) / (torch.sqrt(nu_f / c2) + cfg.eps)
        m = state.master[n]
        master[n] = m - lr * (delta + cfg.weight_decay * m)
        if q8:
            mu[n], nu[n] = _q8_encode(mu_f), nu_f.to(torch.bfloat16)
        else:
            mu[n], nu[n] = mu_f, nu_f
    if isinstance(params, torch.nn.Module):
        for n, p in params.named_parameters():
            p.copy_(master[n])  # copy_ casts to the parameter's dtype
        new_params = params
    else:
        new_params = {n: master[n].to(p.dtype) for n, p in params.items()}
    metrics["param_norm"] = global_norm(master)
    return new_params, OptState(step=step, mu=mu, nu=nu, master=master), metrics
