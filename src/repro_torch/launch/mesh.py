"""Production and debug meshes: named axes with sizes.

Counterpart of ``repro.launch.mesh``.  On one card a mesh owns no
devices: its ranks are indices along tensor axes, as the fabric's ranks
are (``fabric.router.Router`` takes the same sizes and names as its
``grid`` and ``axis_names``).  A mesh is what the sharding rules resolve
against (``runtime.sharding``) and what the dry run sizes per-device
memory for (``launch.dryrun``).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple


class Mesh:
    """Named mesh axes with sizes, in order.

    ``axis_names`` is the tuple of names, ``shape`` an ordered mapping
    axis -> size (as ``jax.sharding.Mesh.shape`` is), ``size`` the number
    of ranks (the product of the sizes)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        sizes = tuple(int(n) for n in shape)
        names = tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {sizes} vs axis names {names}")
        if any(n < 1 for n in sizes):
            raise ValueError(f"mesh axis sizes must be positive: {sizes}")
        self.axis_names: Tuple[str, ...] = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.size: int = math.prod(sizes)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(self.shape.values())

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and list(self.shape.items()) == list(other.shape.items())

    def __hash__(self) -> int:
        return hash(tuple(self.shape.items()))

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks per pod; ``multi_pod`` adds the 2-pod outer axis."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh for tests."""
    return Mesh(shape, axes)
