"""GPipe-style pipeline over a mesh axis.

Counterpart of ``repro.runtime.pipeline``: layers split into ``n_stages``
contiguous groups, and microbatches stream through the stages, one hop a
tick.  The reference runs each stage on its own device under
``shard_map`` and rotates activations with ``ppermute``.  On one card the
stage axis is a tensor axis: the stages' activations of a tick are one
``(n_stages, mb, S, d)`` tensor, rotated one stage by ``torch.roll``.
Activations cross stages as HGum frames conceptually — the activation
block itself is the frame payload (fixed size, so a single-frame list;
the constant headers are elided in the math).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ..launch.costanalysis import record_collective

PyTree = Any


def split_stages(layers: List, n_stages: int) -> List[List]:
    """Contiguous split of the layer list into n_stages groups."""
    n = len(layers)
    per = -(-n // n_stages)
    return [layers[i * per: (i + 1) * per] for i in range(n_stages)]


def _named(p) -> Dict[str, torch.Tensor]:
    return dict(p.named_parameters()) if isinstance(p, torch.nn.Module) else dict(p)


def stack_stage_params(stage_groups: List[List]) -> Dict[str, torch.Tensor]:
    """Stack per-stage groups of layers (modules or dicts of tensors by
    parameter name) on a leading stage axis and a layer axis: ``{name:
    (n_stages, layers_per_stage, ...)}``.  The stages must be homogeneous
    (the caller's layer plan)."""
    stages = [[_named(layer) for layer in grp] for grp in stage_groups]
    names = stages[0][0]
    return {n: torch.stack([torch.stack([layer[n] for layer in grp]) for grp in stages])
            for n in names}


def gpipe_forward(
    mesh,
    axis: str,
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stage_params: Dict[str, torch.Tensor],  # leaves (n_stages, layers_per_stage, ...)
    x: torch.Tensor,  # (n_micro, mb, S, d) microbatched activations
) -> torch.Tensor:
    """Forward-only GPipe schedule: ``n_micro + n_stages - 1`` ticks.

    ``stage_fn(params_for_stage, acts) -> acts``.  Stage ``s`` takes
    microbatch ``t - s`` at tick ``t``: stage 0 reads its own input, the
    others the carry rotated one stage; ticks without a microbatch give
    zeros (their ``stage_fn`` call is skipped: on one card the stages run
    in turn, and the reference zeroes the result); only the last stage
    stores its outputs.  Returns ``(n_micro, mb, S, d)``."""
    n_stages = mesh.shape[axis]
    n_micro = x.shape[0]
    params = [{n: p[s] for n, p in stage_params.items()} for s in range(n_stages)]
    buf = torch.zeros_like(x)
    carry = torch.zeros((n_stages,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for t in range(n_micro + n_stages - 1):
        y = torch.zeros_like(carry)
        for s in range(n_stages):
            m_in = t - s  # microbatch arriving at this stage this tick
            if 0 <= m_in < n_micro:
                y[s] = stage_fn(params[s], x[m_in] if s == 0 else carry[s])
                if s == n_stages - 1:
                    buf[m_in] = y[s]
        # rotate activations forward one stage
        record_collective("collective-permute", y)
        carry = torch.roll(y, shifts=1, dims=0)
    return buf
