"""Gradient compression for the slow cross-pod hop: int8 with error feedback.

Counterpart of ``repro.runtime.compress``, in plain torch as the reference
is plain ``jnp``.  Within a pod, gradients reduce in full precision;
across pods (the ``pod`` axis), each leaf is quantized to int8 with a
per-leaf scale, and the quantization error is carried to the next step
(error feedback).  The cross-pod gradient volume drops 4x (fp32) / 2x
(bf16).

Trees are dicts of tensors (grads keyed by parameter name) or a model
(read as the dict of its parameters).  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so every function gives the reference's bits.
The reference's ``cross_pod_mean_int8`` only runs compiled (under
``shard_map``), where XLA fuses its residual ``g - q * scale`` into one
multiply-add, rounded once; :func:`_fused_residual` computes it in
float64, where the product (an int8 times a float32) and the difference
(at most half a step) are exact, and rounds once, which gives the same
bits.  The per-leaf helpers round as the reference's eager ops do.
Every division is by a tensor on the operands' device: CUDA divides by a
Python number as a product with its reciprocal, which is not the
quotient's bits (``x / 127`` is not ``x * (1 / 127)``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..launch.costanalysis import record_collective

PyTree = Any


def _leaves(tree) -> Dict[str, Any]:
    return dict(tree.named_parameters()) if isinstance(tree, torch.nn.Module) else tree


def _map(fn: Callable, *trees) -> Dict[str, Any]:
    first = _leaves(trees[0])
    rest = [_leaves(t) for t in trees[1:]]
    return {k: fn(v, *(t[k] for t in rest)) for k, v in first.items()}


def quantize_leaf(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8, scale). Error feedback is added before quantization."""
    g = g.float() + err
    scale = _div(torch.clamp(g.abs().amax(), min=1e-12), 127)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n``, rounded as a true division on every device."""
    return x / x.new_tensor(n, dtype=torch.float32)


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _fused_residual(g32: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g32 - q * scale`` rounded once to float32 (see the module docstring)."""
    return (g32.double() - q.double() * scale.double()).float()


def init_error(params: PyTree) -> Dict[str, torch.Tensor]:
    return _map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), params)


def compress_tree(grads: PyTree, err: PyTree):
    qs = _map(quantize_leaf, grads, err)
    return {k: v[0] for k, v in qs.items()}, {k: v[1] for k, v in qs.items()}


def decompress_tree(q: PyTree, s: PyTree) -> Dict[str, torch.Tensor]:
    return _map(dequantize_leaf, q, s)


def new_error(grads: PyTree, err: PyTree, q: PyTree, s: PyTree) -> Dict[str, torch.Tensor]:
    """Residual carried to the next step."""
    return _map(lambda g, e, qq, ss: g.float() + e - dequantize_leaf(qq, ss), grads, err, q, s)


def _mean_leaf(g: torch.Tensor, e: torch.Tensor, n: int):
    g32 = g.float() + e
    # pmax over the pod axis of each member's max-abs: one scalar per member
    # on the wire
    local = torch.clamp(g32.reshape(n, -1).abs().amax(dim=1), min=1e-12)
    record_collective("all-reduce", local)
    scale = _div(local.amax(), 127)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    q32 = q.to(torch.int32)
    record_collective("all-reduce", q32)
    mean = _div(q32.sum(dim=0).float() * scale, n)
    return mean.expand(g.shape), _fused_residual(g32, q, scale)


def cross_pod_mean_int8(
    grads: PyTree, err: PyTree, axis_name: str = "pod"
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Mean-reduce compressed grads over the pod axis.  Returns (mean grads
    fp32, new error).

    On one card the pod axis is a tensor axis: every leaf of ``grads`` and
    ``err`` carries it as its leading dimension, one row per pod member,
    as the reference's ``shard_map`` stacks them.  A shared per-leaf scale
    (the reference's ``pmax`` of each member's max-abs, here an amax over
    the axis) makes the int8 payloads commensurable; the reduction (the
    ``psum``) is an int32 sum over the axis (no overflow below 2^23 pods),
    dequantized once.  The mean comes back with the axis, every member's
    row the same (a broadcast view), and the error per member.
    ``axis_name`` names the axis; the leading dimension is it."""
    out = _map(lambda g, e: _mean_leaf(g, e, g.shape[0]), grads, err)
    return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}
