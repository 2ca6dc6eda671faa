"""Sharding rules: map every parameter / activation / cache leaf to a
PartitionSpec over a mesh.

Counterpart of ``repro.runtime.sharding``; the rules are the reference's,
line for line.  Baseline layout:

* batch over ``("pod", "data")`` (pod is an outer DP axis when present);
* params: FSDP over ``data`` on one matrix dim, TP over ``model`` on the
  other (vocab / d_ff / heads over ``model``);
* MoE experts: EP over ``model`` when the expert count divides the axis,
  otherwise TP inside each expert;
* KV caches: batch over data axes, kv-heads over ``model`` when divisible
  (MQA kv=1 falls back to head-dim or time sharding);
* small vectors (norms, biases, scalars) replicated.

Divisibility is always checked against the mesh's axis sizes — a rule
that does not divide falls back to replication on that dim, so every
config resolves on every mesh.

The rules are regexes on the reference's pytree paths
(``jax.tree_util.keystr``), so the port's trees are read by those paths:
a model's parameter ``layers.0.attn.wq`` is ``['layers'][0]['attn']['wq']``,
an ``OptState`` field is ``.mu``, q8's blocks ``['q']`` and scales
``['s']``, a cache's ``['layers'][3]['k']`` or ``['enc_kv'][0][1]``.

On one card nothing is placed: a :class:`NamedSharding` says which slice
of a leaf each rank of the mesh would hold (:meth:`NamedSharding.shard_shape`),
and :func:`with_sharding_constraint` checks a spec against a tensor and
returns the tensor unchanged.
"""
from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..launch.mesh import Mesh
from ..models.common import keystr, path_parts

PyTree = Any


def _entry(e):
    """A spec entry as ``jax.sharding.PartitionSpec`` keeps it: a list is a
    tuple, an empty tuple is ``None`` and a 1-tuple its one name."""
    if isinstance(e, list):
        e = tuple(e)
    if isinstance(e, tuple):
        if any(isinstance(a, (tuple, list)) for a in e):
            raise ValueError(f"a spec entry cannot nest a tuple: {e!r}")
        if not e:
            return None
        if len(e) == 1:
            return e[0]
    return e


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``
    (replicated), an axis name, or a tuple of axis names (the dim split
    over their product).  Entries compare as the reference's
    ``PartitionSpec`` entries do (see :func:`_entry`); trailing ``None``s
    are kept."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: which slice of a leaf each rank holds."""

    mesh: Mesh
    spec: P

    def shard_shape(self, global_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Per-rank shape of a ``global_shape`` leaf; raises where the spec
        does not fit it (more entries than dims, an unknown or reused axis,
        or a dim its axes do not divide)."""
        shape = tuple(int(d) for d in global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {shape}")
        out, used = list(shape), set()
        for i, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            for a in axes:
                if a not in self.mesh.shape:
                    raise ValueError(f"axis {a!r} of {self.spec} not in {self.mesh}")
                if a in used:
                    raise ValueError(f"axis {a!r} used twice in {self.spec}")
                used.add(a)
            n = math.prod(self.mesh.shape[a] for a in axes)
            if shape[i] % n:
                raise ValueError(f"dim {i} of {shape} is not divisible by {n} ({entry!r})")
            out[i] = shape[i] // n
        return tuple(out)


def with_sharding_constraint(x, shardings):
    """``jax.lax.with_sharding_constraint`` on one card: every leaf's spec
    is checked against its shape (:meth:`NamedSharding.shard_shape`), and
    ``x`` comes back unchanged.  ``shardings`` is one sharding or a tree
    of the same structure as ``x``."""
    if isinstance(shardings, NamedSharding):
        tree_map_with_path(lambda _, t: shardings.shard_shape(tuple(t.shape)), x)
        return x
    got = dict(leaf_paths(shardings))
    for path, t in leaf_paths(x):
        got[path].shard_shape(tuple(t.shape))
    return x


# ---------------------------------------------------------------------------
# Trees read by the reference's paths
# ---------------------------------------------------------------------------


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: PyTree, path: str = "") -> PyTree:
    """``fn(keystr path, leaf)`` over a tree of dicts, lists, tuples,
    dataclasses (``OptState``) and modules (a module is the dict of its
    named parameters), in the reference's flatten order; returns the same
    structure (a module as that dict).  A :class:`NamedSharding` is a
    leaf."""
    if isinstance(tree, NamedSharding):
        return fn(path, tree)
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        keys = sorted(tree, key=lambda k: path_parts(str(k)))
        return {k: tree_map_with_path(fn, tree[k], path + keystr(path_parts(str(k))))
                for k in keys}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), f"{path}.{f.name}")
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def leaf_paths(tree: PyTree):
    """[(keystr path, leaf)] in the reference's flatten order."""
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardRules:
    """Layout knobs (the reference's, with its defaults)."""

    batch: Tuple[str, ...] = ("pod", "data")  # filtered by mesh axes present
    fsdp: Any = "data"  # an axis name, or a tuple (ZeRO over ("pod", "data"))
    tensor: str = "model"
    # MoE
    expert_parallel: bool = True  # EP over `tensor` when divisible
    # caches
    kv_head_sharded: bool = True
    kv_time_sharded_when_b1: bool = True  # long_500k: shard cache time dim
    # embeddings
    vocab_sharded: bool = True
    # activations
    seq_sharded_acts: bool = False  # sequence parallelism for norms/residual
    # replicate params smaller than this many elements (0 = off)
    replicate_below: int = 0


def _axes(mesh: Mesh, names: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(n for n in names if n in mesh.axis_names)


def _size(mesh: Mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    s = 1
    for n in names:
        s *= mesh.shape[n]
    return s


def _fit(mesh: Mesh, dim: int, names) -> Optional[Any]:
    """Axis name(s) if `dim` divides their total size, else None."""
    if names is None:
        return None
    if isinstance(names, str):
        names = (names,)
    names = _axes(mesh, tuple(names))
    if not names:
        return None
    if dim % _size(mesh, names) == 0:
        return names if len(names) > 1 else names[0]
    return None


# (regex on leaf path, per-dim axis *requests*); first match wins.
# dim requests are resolved against shapes with divisibility fallback.
def _param_rules(rules: ShardRules):
    f, t = rules.fsdp, rules.tensor
    return [
        # embeddings / unembedding: vocab over `tensor`, d_model replicated
        (r"\['embed'\]$", ((t if rules.vocab_sharded else None), None)),
        (r"\['lm_head'\]$", (None, t)),
        (r"\['vision_proj'\]$", (None, f)),
        # attention
        (r"\['attn'\]\['wq'\]$", (f, t)),
        (r"\['attn'\]\['wk'\]$", (f, t)),
        (r"\['attn'\]\['wv'\]$", (f, t)),
        (r"\['attn'\]\['wo'\]$", (t, f)),
        # dense ffn
        (r"\['ffn'\]\['wi'\]$", (f, t)),
        (r"\['ffn'\]\['wg'\]$", (f, t)),
        (r"\['ffn'\]\['wo'\]$", (t, f)),
        # moe (leading dim = experts)
        (r"\['moe'\]\['router'\]$", (f, None)),
        (r"\['moe'\]\['w[ig]'\]$", ("__EP__", f, t)),
        (r"\['moe'\]\['wo'\]$", ("__EP__", t, f)),
        # mamba
        (r"\['mamba'\]\['in_proj'\]$", (f, t)),
        (r"\['mamba'\]\['out_proj'\]$", (t, f)),
        (r"\['mamba'\]\['conv_[wb]'\]$", None),
        # mlstm / slstm
        (r"\['mlstm'\]\['w[qkv]'\]$", (f, t)),
        (r"\['mlstm'\]\['wo_gate'\]$", (f, t)),
        (r"\['mlstm'\]\['out_proj'\]$", (t, f)),
        (r"\['mlstm'\]\['wif'\]$", (f, None)),
        (r"\['slstm'\]\['[wr][ifzo]'\]$", (f, t)),
    ]


def param_pspec(
    path: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh: Mesh, rules: ShardRules
) -> P:
    # q8 optimizer-moment blocks/scales: flattened (n_blocks, 256)/(n_blocks,)
    # — shard the block dim over every available axis (it is huge).
    if re.search(r"\['[qs]'\]$", path):
        for axes in (("pod", "data", "model"), ("data", "model"),
                     ("pod", "data"), ("data",), ("model",)):
            got = _fit(mesh, shape[0], axes)
            if got is not None:
                return P(*([got] + [None] * (len(shape) - 1)))
        return P()
    n_elems = 1
    for dim in shape:
        n_elems *= dim
    if rules.replicate_below and n_elems < rules.replicate_below:
        return P()
    for pat, req in _param_rules(rules):
        if re.search(pat, path):
            if req is None or len(shape) != len(req):
                return P()
            out = []
            for dim, want in zip(shape, req):
                if want == "__EP__":
                    want = rules.tensor if rules.expert_parallel else None
                    got = _fit(mesh, dim, want)
                    # EP eats the tensor axis for this tensor: the later
                    # dims may not reuse it
                    if got is not None:
                        out.append(got)
                        rest = [
                            _fit(mesh, d, w if w != got and w != rules.tensor else None)
                            for d, w in zip(shape[len(out):], req[len(out):])
                        ]
                        out.extend(rest)
                        return P(*out)
                    out.append(None)
                    continue
                out.append(_fit(mesh, dim, want))
            return P(*out)
    return P()  # norms, biases, scalars: replicated


def param_shardings(
    params_or_shapes: PyTree, cfg: ModelConfig, mesh: Mesh,
    rules: Optional[ShardRules] = None,
) -> PyTree:
    """A :class:`NamedSharding` per leaf of a model (as the dict of its
    parameters by name), an ``OptState`` or any tree of tensors."""
    rules = rules or ShardRules()
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, param_pspec(path, tuple(leaf.shape), cfg, mesh, rules)),
        params_or_shapes)


# ---------------------------------------------------------------------------
# Activations / batch / cache specs
# ---------------------------------------------------------------------------


def batch_pspec(mesh: Mesh, rules: ShardRules, global_batch: int) -> P:
    axes = _axes(mesh, rules.batch)
    # drop trailing axes until the batch divides
    while axes and global_batch % _size(mesh, axes) != 0:
        axes = axes[:-1]
    return P(axes if axes else None)


def batch_shardings(batch: PyTree, mesh: Mesh, rules: Optional[ShardRules] = None,
                    global_batch: Optional[int] = None) -> PyTree:
    rules = rules or ShardRules()

    def spec(_, x):
        gb = global_batch or x.shape[0]
        bp = batch_pspec(mesh, rules, gb)
        return NamedSharding(mesh, P(*(list(bp) + [None] * (len(x.shape) - 1))))

    return tree_map_with_path(spec, batch)


def cache_pspec(
    path: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh: Mesh, rules: ShardRules
) -> P:
    bax = batch_pspec(mesh, rules, shape[0])[0] if shape else None
    if re.search(r"\['pos'\]$", path):
        return P(bax)
    if re.search(r"\['(k|v)'\]$", path) or "enc_kv" in path:
        # (B, T, K, D).  Preference order for the tensor axis: kv heads
        # (K % axis == 0) > head_dim > time (only when B=1: decode writes
        # along T, so a time-sharded cache pays a reshard per step otherwise).
        B, T, K, D = shape
        kv_ax = _fit(mesh, K, rules.tensor) if rules.kv_head_sharded else None
        d_ax = None
        t_ax = None
        if kv_ax is None:
            d_ax = _fit(mesh, D, rules.tensor)
        if kv_ax is None and d_ax is None and bax is None and rules.kv_time_sharded_when_b1:
            t_ax = _fit(mesh, T, rules.tensor)
        return P(bax, t_ax, kv_ax, d_ax)
    if re.search(r"\['ssm'\]$", path):  # (B, nh, P, N)
        return P(bax, _fit(mesh, shape[1], rules.tensor), None, None)
    if re.search(r"\['conv'\]$", path):  # (B, K-1, d_in)
        return P(bax, None, _fit(mesh, shape[2], rules.tensor))
    if re.search(r"\['C'\]$", path):  # mlstm (B, nh, dh, dh)
        return P(bax, _fit(mesh, shape[1], rules.tensor), None, None)
    if re.search(r"\['n'\]$", path) and len(shape) == 3:
        return P(bax, _fit(mesh, shape[1], rules.tensor), None)
    if len(shape) == 2:  # slstm states (B, d) / mlstm m (B, nh)
        return P(bax, _fit(mesh, shape[1], rules.tensor))
    return P(*([bax] + [None] * (len(shape) - 1)))


def cache_shardings(
    cache: PyTree, cfg: ModelConfig, mesh: Mesh, rules: Optional[ShardRules] = None
) -> PyTree:
    rules = rules or ShardRules()
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, cache_pspec(path, tuple(leaf.shape), cfg, mesh, rules)),
        cache)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
