"""Gradient-accumulation microbatching, counterpart of ``repro.optim.microbatch``.

Keeps per-microbatch live activations 1/k of the full batch.  The first
microbatch runs on its own; every later one's grads are added to float32
accumulators, and the sums are scaled by ``1/n``.  Grads come from
``torch.autograd.grad``, never accumulated in ``.grad``, so a bf16 model's
microbatch grads are added in float32 as the reference adds them, never
in bf16.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .adamw import Params, _named


def _trainable(params: Params) -> Dict[str, torch.Tensor]:
    """The parameters by name, each set to take gradients."""
    named = _named(params)
    for p in named.values():
        p.requires_grad_(True)
    return named


def _value_and_grad(loss_fn, params: Params, named: Dict[str, torch.Tensor], batch: Dict):
    """(loss, metrics, grads) of one batch; a parameter off the loss's path
    gets zeros, as ``jax.value_and_grad`` gives it."""
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def microbatched_grads(
    loss_fn: Callable[[Params, Dict], Tuple[torch.Tensor, Dict]],
    params: Params,
    batch: Dict[str, torch.Tensor],
    n_micro: int,
    constrain: Callable = lambda g: g,
    constrain_micro: Callable = lambda b: b,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """Mean loss/grads over ``n_micro`` slices of the leading batch axis.

    With ``n_micro <= 1`` the grads come back in each parameter's dtype,
    otherwise in float32.  ``constrain`` and ``constrain_micro`` are the
    reference's sharding hooks (identity on one device)."""
    named = _trainable(params)
    if n_micro <= 1:
        loss, metrics, grads = _value_and_grad(loss_fn, params, named, batch)
        return loss, constrain(grads), metrics

    def reshape(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro}")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    micro = constrain_micro({k: reshape(v) for k, v in batch.items()})
    loss, metrics, g0 = _value_and_grad(loss_fn, params, named, {k: v[0] for k, v in micro.items()})
    acc = constrain({n: g.float() for n, g in g0.items()})
    del g0
    for i in range(1, n_micro):
        li, mi, gi = _value_and_grad(loss_fn, params, named, {k: v[i] for k, v in micro.items()})
        for n, g in gi.items():
            acc[n].add_(g)  # float32 += the microbatch's grad, upcast exactly
        del gi
        loss = loss + li
        metrics = {k: metrics.get(k, 0.0) + v for k, v in mi.items()}
    inv = 1.0 / n_micro
    grads = {n: (g * inv).float() for n, g in acc.items()}
    return loss * inv, grads, {k: v * inv for k, v in metrics.items()}
