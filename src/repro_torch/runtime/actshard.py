"""Activation-sharding hook.

Counterpart of ``repro.runtime.actshard``.  Models are mesh-agnostic;
launchers install a constrainer that pins named activation classes to
partition specs.  In the reference that pin is
``jax.lax.with_sharding_constraint``, which keeps SPMD propagation from
leaking weight shardings into the residual stream.  On one card it is the
identity on values: :class:`MeshConstrainer` checks that the spec fits the
activation's shape, records ``(kind, shape, spec)`` for the dry run, and
returns the tensor unchanged.

Kinds (the models' five call sites):
  residual    — (B, S, d) layer inputs/outputs: P(batch, None, None)
  logits      — (B, S, V): P(batch, None, vocab_axis)
  tokens_flat — (B*S, d) MoE output rows: over (fsdp, tensor) as they divide
  moe_buffer  — (E, C, d|ff): EP over tensor, or the capacity dim
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Set, Tuple

import torch

Constrainer = Callable[[torch.Tensor, str], torch.Tensor]

_constrainer: contextvars.ContextVar[Constrainer] = contextvars.ContextVar(
    "act_constrainer", default=lambda x, kind: x
)


def constrain(x, kind: str):
    """Apply the installed activation constraint (identity by default)."""
    return _constrainer.get()(x, kind)


@contextlib.contextmanager
def use_constrainer(fn: Constrainer):
    tok = _constrainer.set(fn)
    try:
        yield
    finally:
        _constrainer.reset(tok)


class MeshConstrainer:
    """The standard constrainer: batch axes on dim 0, vocab over the tensor
    axis (the reference's ``mesh_constrainer``).  ``records`` holds the
    distinct ``(kind, shape, spec)`` of the constrained activations."""

    def __init__(self, mesh, rules, global_batch: int):
        self.mesh, self.rules, self.global_batch = mesh, rules, global_batch
        self.records: Set[Tuple[str, Tuple[int, ...], Any]] = set()

    def spec(self, shape: Tuple[int, ...], kind: str):
        """The reference's spec (a ``runtime.sharding.P``) for an activation
        of ``shape`` and ``kind``; ``None`` where it leaves the activation
        unconstrained."""
        # the models import this module, and sharding imports the models'
        # helpers: import it at first use, as the reference does
        from .sharding import P, batch_pspec

        mesh, rules, ndim = self.mesh, self.rules, len(shape)
        if ndim < 2:
            return None
        tsz = mesh.shape.get(rules.tensor, 1)
        fsz = mesh.shape.get(rules.fsdp, 1) if isinstance(rules.fsdp, str) else 1
        if kind == "moe_buffer":  # (E, C, d|ff)
            # EP when E divides the tensor axis; otherwise shard the
            # capacity dim over both axes
            e_ax = rules.tensor if shape[0] % tsz == 0 else None
            C = shape[1]
            if e_ax is not None:
                c_ax = rules.fsdp if C % fsz == 0 else None
            elif C % (fsz * tsz) == 0:
                c_ax = (rules.fsdp, rules.tensor)
            elif C % fsz == 0:
                c_ax = rules.fsdp
            elif C % tsz == 0:
                c_ax = rules.tensor
            else:
                c_ax = None
            return P(e_ax, c_ax, *([None] * (ndim - 2)))
        if kind == "tokens_flat":  # (B*S, d): rows are B-major
            n = shape[0]
            if n % (fsz * tsz) == 0:
                ax = (rules.fsdp, rules.tensor)
            elif n % fsz == 0:
                ax = rules.fsdp
            elif n % tsz == 0:
                ax = rules.tensor
            else:
                ax = None
            return P(ax, *([None] * (ndim - 1)))
        bax = batch_pspec(mesh, rules, shape[0])
        used = set()
        for entry in bax:
            if isinstance(entry, (tuple, list)):
                used.update(entry)
            elif entry is not None:
                used.add(entry)
        if kind == "residual":
            return P(*(list(bax) + [None] * (ndim - 1)))
        if kind == "logits":
            ax = rules.tensor if (
                shape[-1] % mesh.shape[rules.tensor] == 0
                and rules.tensor not in used  # batch may own every axis (pure DP)
            ) else None
            return P(*(list(bax) + [None] * (ndim - 2) + [ax]))
        return None

    def __call__(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        from .sharding import NamedSharding

        shape = tuple(x.shape)
        spec = self.spec(shape, kind)
        if spec is not None:
            NamedSharding(self.mesh, spec).shard_shape(shape)
            self.records.add((kind, shape, spec))
        return x


def mesh_constrainer(mesh, rules, global_batch: int) -> MeshConstrainer:
    """Standard constrainer: batch axes on dim 0, vocab over tensor axis."""
    return MeshConstrainer(mesh, rules, global_batch)
