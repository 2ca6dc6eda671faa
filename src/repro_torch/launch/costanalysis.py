"""Cost accounting of a step as it runs, and the H100 roofline.

Counterpart of ``repro.launch.hloanalysis``.  PyTorch runs eagerly and has
no compiled module to read, so the costs come from the ops themselves:
:func:`analyze` runs a function under a ``TorchDispatchMode`` (below
autograd, so a backward pass and its recomputation are seen too) and
counts, per ATen op:

* ``dot_flops`` — matrix products (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``dot``; ``einsum`` and ``matmul`` reach these):
  2 x output elements x contracted size;
* ``flops`` — ``dot_flops`` plus one per output element of every
  elementwise op (ATen's ``pointwise`` tag) and every reduction, as the
  reference counts them;
* ``hbm_bytes`` — every op that materialises a result: the bytes of its
  tensor inputs, read once, and of its outputs, written once.  Views,
  reshapes and allocations (``empty*``) are free, as the reference's
  ``_FREE`` ops are.  An eager op is its own kernel here, so casts and
  copies count;
* ``collective_*`` — the reductions and rolls along a mesh axis that the
  port's per-rank code performs, where it tags them
  (:func:`record_collective`: ``runtime.compress``, ``runtime.channels``,
  ``runtime.pipeline``), by kind: operand and output bytes, summed over
  the axis's members.

Run on ``meta`` tensors, nothing is allocated or computed: shapes and
dtypes alone give every count, so a full-size step is costed on any host.
Counts are Python ints, exact at any size.  A trace sees the work of
every rank of a tensor-axis mesh together (the whole step on one card);
``launch.dryrun`` splits it over a mesh.

The roofline constants below are the H100's, each with its source, for
an NVIDIA H100 80GB HBM3 at its 700.00 W power limit.
"""
from __future__ import annotations

import contextvars
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: dense bf16 tensor-core peak, FLOP/s (NVIDIA H100 SXM datasheet)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth, B/s (NVIDIA H100 SXM datasheet)
HBM_BW = 3.35e12
#: NVLink bandwidth to the host's other cards, one direction, B/s
#: (NVIDIA H100 SXM datasheet: 900 GB/s all to all, 450 GB/s each way)
NVLINK_BW = 450e9
#: device memory, bytes: ``torch.cuda.get_device_properties(0).total_memory``
#: as an NVIDIA H100 80GB HBM3 (700.00 W) reports it
HBM_BYTES = 85_017_493_504

_aten = torch.ops.aten
#: matrix products -> index of the left operand in the op's arguments
_DOTS = {
    _aten.mm: 0, _aten.bmm: 0, _aten.mv: 0, _aten.dot: 0,
    _aten.addmm: 1, _aten.baddbmm: 1,
}
_REDUCE = {
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
    _aten.argmax, _aten.argmin, _aten.prod, _aten.var, _aten.var_mean,
    _aten.std, _aten.logsumexp, _aten.cumsum, _aten.all, _aten.any,
    _aten.norm, _aten.linalg_vector_norm, _aten._softmax, _aten._log_softmax,
    _aten._softmax_backward_data, _aten._log_softmax_backward_data,
}
_FREE = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.lift_fresh, _aten.alias,
    _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
}


@dataclass
class CostReport:
    flops: int = 0
    hbm_bytes: int = 0
    collective_op_bytes: Dict[str, int] = field(default_factory=dict)
    collective_out_bytes: Dict[str, int] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    dot_flops: int = 0
    notes: List[str] = field(default_factory=list)

    @property
    def collective_bytes(self) -> int:
        return sum(self.collective_op_bytes.values())

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_op_bytes": dict(self.collective_op_bytes),
            "collective_out_bytes": dict(self.collective_out_bytes),
            "collective_count": dict(self.collective_count),
            "notes": list(self.notes),
        }


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts every ATen op run inside it into ``report``."""

    def __init__(self):
        super().__init__()
        self.report = CostReport()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        rep = self.report
        outs = _tensors(out)
        out_elems = sum(t.numel() for t in outs)
        if packet in _DOTS:
            lhs = args[_DOTS[packet]]
            f = 2 * out_elems * lhs.shape[-1] if packet is not _aten.dot else 2 * lhs.numel()
            rep.flops += f
            rep.dot_flops += f
        elif packet in _REDUCE or torch.Tag.pointwise in func.tags:
            rep.flops += out_elems
        if not func.is_view and packet not in _FREE:
            rep.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            rep.hbm_bytes += sum(_nbytes(t) for t in outs)
        return out


_ACTIVE: contextvars.ContextVar[Optional[CostMode]] = contextvars.ContextVar(
    "cost_mode", default=None)


def record_collective(kind: str, operand: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> None:
    """Count one collective of ``kind`` (``all-reduce``,
    ``collective-permute``, ...) over ``operand`` (every member's data,
    stacked on the mesh axis) into the :func:`analyze` that is running;
    nothing outside one."""
    mode = _ACTIVE.get()
    if mode is None:
        return
    rep = mode.report
    rep.collective_op_bytes[kind] = rep.collective_op_bytes.get(kind, 0) + _nbytes(operand)
    out_b = _nbytes(operand if out is None else out)
    rep.collective_out_bytes[kind] = rep.collective_out_bytes.get(kind, 0) + out_b
    rep.collective_count[kind] = rep.collective_count.get(kind, 0) + 1


def analyze(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), CostReport)`` of one call."""
    mode = CostMode()
    tok = _ACTIVE.set(mode)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.reset(tok)
    return out, mode.report


def roofline_terms(rep: CostReport, n_chips: int = 1) -> Dict[str, float]:
    """Seconds per term for a report of one call split evenly over
    ``n_chips`` cards: compute at :data:`PEAK_FLOPS`, memory at
    :data:`HBM_BW`, collectives at :data:`NVLINK_BW`."""
    return {
        "t_compute": rep.flops / n_chips / PEAK_FLOPS,
        "t_memory": rep.hbm_bytes / n_chips / HBM_BW,
        "t_collective": rep.collective_bytes / n_chips / NVLINK_BW,
    }
