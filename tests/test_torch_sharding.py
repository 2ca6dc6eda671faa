"""Port parity, the sharding rules and the input specs: ``param_pspec``,
``cache_pspec``, ``batch_pspec`` and ``NamedSharding.shard_shape`` for every
leaf of ``params_specs``, ``opt_specs`` (fp32 and q8) and ``cache_specs``
of all ten architectures at full config, on the meshes (2,2,2), (16,16)
and (2,16,16), the rule variants, ``mesh_constrainer``'s spec per kind,
the models' five ``constrain`` sites, and ``input_specs`` for every
supported (arch x shape) cell, against the JAX package.

The reference resolves its rules against ``jax.sharding.AbstractMesh``
(nothing allocated), the port against ``launch.mesh.Mesh``; the port's
specs are tensors on ``meta``.  Every comparison is exact: specs entry
by entry, shapes and dtypes by name.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_archs, get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.configs import supports_shape
from repro.launch import steps as jsteps
from repro.models import ffn as jffn
from repro.optim import adamw_init as j_adamw_init
from repro.models import forward as j_forward
from repro.runtime import actshard as jact
from repro.runtime import sharding as jsh
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_production_mesh
from repro_torch.models import ffn as tffn
from repro_torch.models import forward
from repro_torch.runtime import actshard as tact
from repro_torch.runtime import sharding as tsh
from torch_parity import twin_models

MESHES = [((2, 2, 2), ("pod", "data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
#: (name, ShardRules changes, archs): the dry run's flags and knobs
VARIANTS = [
    ("no-ep", {"expert_parallel": False},
     ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b")),
    ("no-kv-heads", {"kv_head_sharded": False}, ("yi-6b", "granite-34b", "whisper-tiny")),
    ("replicate_below", {"replicate_below": 1 << 20}, ("xlstm-125m", "yi-6b")),
    ("fsdp-pod-data", {"fsdp": ("pod", "data")}, ("yi-6b", "jamba-1.5-large-398b")),
]


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype)) for k, v in flat]


def _port_flat(tree):
    return [(p, tuple(t.shape), str(t.dtype)[len("torch."):]) for p, t in tsh.leaf_paths(tree)]


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """{name: (reference tree, port tree)} of the full config's specs.  The
    reference's ``opt_specs`` is ``eval_shape(adamw_init)`` of its
    ``params_specs``; it is taken here from the params already built."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jparams = jsteps.params_specs(jcfg)

    def j_opt(moments):
        return jax.eval_shape(lambda q: j_adamw_init(q, moments), jparams)

    return {
        "params": (jparams, tsteps.params_specs(cfg)),
        "opt_fp32": (j_opt("fp32"), tsteps.opt_specs(dataclasses.replace(cfg, opt_moments="fp32"))),
        "opt_q8": (j_opt("q8"), tsteps.opt_specs(dataclasses.replace(cfg, opt_moments="q8"))),
        "cache_b128": (jsteps.cache_specs(jcfg, 128, 4096), tsteps.cache_specs(cfg, 128, 4096)),
        "cache_b1": (jsteps.cache_specs(jcfg, 1, 8192), tsteps.cache_specs(cfg, 1, 8192)),
    }


@functools.lru_cache(maxsize=None)
def _ref_shard_shape(mesh_key, spec, shape):
    return tuple(JNamedSharding(AbstractMesh(*mesh_key), jax.sharding.PartitionSpec(*spec))
                 .shard_shape(shape))


def _resolve(tree_pair, fn_pair, cfgs, mesh_key, rules_kw):
    """[(path, spec, shard_shape)] per package."""
    (jtree, ttree), (jfn, tfn), (jcfg, cfg) = tree_pair, fn_pair, cfgs
    amesh, tmesh = AbstractMesh(*mesh_key), Mesh(*mesh_key)
    jrules, trules = jsh.ShardRules(**rules_kw), tsh.ShardRules(**rules_kw)
    ref = []
    for path, shape, _ in _ref_flat(jtree):
        spec = tuple(jfn(path, shape, jcfg, amesh, jrules))
        ref.append((path, spec, _ref_shard_shape(mesh_key, spec, shape)))
    got = []
    for path, leaf in tsh.leaf_paths(ttree):
        spec = tfn(path, tuple(leaf.shape), cfg, tmesh, trules)
        got.append((path, tuple(spec),
                    tsh.NamedSharding(tmesh, spec).shard_shape(tuple(leaf.shape))))
    return ref, got


def _check_arch(arch, rules_kw, meshes=MESHES):
    cfgs = (j_get_config(arch), get_config(arch))
    trees = _trees(arch)
    n = 0
    for mesh_key in meshes:
        for name, pair in trees.items():
            fns = ((jsh.cache_pspec, tsh.cache_pspec) if name.startswith("cache")
                   else (jsh.param_pspec, tsh.param_pspec))
            ref, got = _resolve(pair, fns, cfgs, mesh_key, rules_kw)
            assert got == ref, (arch, mesh_key, name,
                                [x for x in zip(ref, got) if x[0] != x[1]][:3])
            n += len(ref)
    return n


@pytest.mark.parametrize("arch", all_archs())
def test_specs_and_shard_shapes_match_reference(arch):
    """Every leaf of the params, both optimizer states and two caches
    (B=128, and B=1 where the time dim may take the tensor axis): the same
    path, spec and per-device shape, on all three meshes."""
    assert _check_arch(arch, {}) > 0


@pytest.mark.parametrize("variant,rules_kw,arch",
                         [(v, kw, a) for v, kw, archs in VARIANTS for a in archs])
def test_rule_variants_match_reference(variant, rules_kw, arch):
    meshes = [m for m in MESHES if "pod" in m[1]] if "pod" in str(rules_kw) else MESHES
    assert _check_arch(arch, rules_kw, meshes) > 0


@pytest.mark.parametrize("mesh_key", MESHES)
def test_batch_pspec_and_shardings_match_reference(mesh_key):
    amesh, tmesh = AbstractMesh(*mesh_key), Mesh(*mesh_key)
    for rules_kw in ({}, {"batch": ("pod", "data", "model")}, {"batch": ("data",)}):
        jr, tr = jsh.ShardRules(**rules_kw), tsh.ShardRules(**rules_kw)
        for gb in list(range(1, 70)) + [128, 256, 384, 512, 1000, 1024]:
            assert tuple(tsh.batch_pspec(tmesh, tr, gb)) == tuple(jsh.batch_pspec(amesh, jr, gb))
    jb = jsteps.batch_specs(j_get_config("phi-3-vision-4.2b"), 32, 64, "train")
    tb = tsteps.batch_specs(get_config("phi-3-vision-4.2b"), 32, 64, "train")
    ref = jsh.batch_shardings(jb, amesh, global_batch=32)
    got = tsh.batch_shardings(tb, tmesh, global_batch=32)
    assert {k: tuple(v.spec) for k, v in got.items()} == {k: tuple(v.spec) for k, v in ref.items()}


def test_partition_spec_entries_compare_as_the_reference():
    """1-tuples collapse to their name, lists to tuples, () to None; trailing
    Nones stay; replicated and shard shapes."""
    JP = jax.sharding.PartitionSpec
    P = tsh.P
    cases = [(("pod",),), ("pod",), (("pod", "data"),), ((),), (["a", "b"],), ("a", None),
             (None,), ()]
    for entries in cases:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
    assert P(("pod",)) == P("pod") and P("a", None) != P("a") and P(None) != P()
    mesh = make_debug_mesh((2, 4), ("data", "model"))
    ns = tsh.NamedSharding(mesh, P(("data", "model"), None))
    assert ns.shard_shape((16, 3)) == (2, 3)
    assert tsh.replicated(mesh).shard_shape((5, 7)) == (5, 7)
    for bad in (P("data", "data"), P("nope"), P(None, None, None)):
        with pytest.raises(ValueError):
            tsh.NamedSharding(mesh, bad).shard_shape((4, 4))
    with pytest.raises(ValueError, match="divisible"):
        tsh.NamedSharding(mesh, P("model")).shard_shape((6,))


def test_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.axis_names, dict(single.shape), single.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, list(multi.shape.values()), multi.size) == (
        ("pod", "data", "model"), [2, 16, 16], 512)
    dbg = make_debug_mesh()
    assert dbg.axis_names == ("data", "model") and dbg.sizes == (2, 2)
    assert Mesh((2, 2), ("data", "model")) == dbg
    with pytest.raises(ValueError):
        Mesh((2, 2), ("a",))


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------


def _ref_constraint_spec(mesh_key, rules_kw, gb, shape, kind, monkeypatch):
    """The spec the reference's constrainer pins, captured at its
    ``with_sharding_constraint``; None where it returns ``x`` untouched."""
    got = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: got.append(tuple(s.spec)) or x)
    fn = jact.mesh_constrainer(AbstractMesh(*mesh_key), jsh.ShardRules(**rules_kw), gb)
    fn(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
    return got[0] if got else None


@pytest.mark.parametrize("mesh_key", MESHES)
def test_mesh_constrainer_specs_match_reference(mesh_key, monkeypatch):
    shapes = {
        "residual": [(b, 16, 64) for b in (1, 2, 3, 4, 8, 32, 256)],
        "logits": [(b, 16, v) for b in (1, 4, 8, 256) for v in (64000, 64001, 512)],
        "tokens_flat": [(n, 64) for n in (1, 2, 3, 16, 48, 256, 4096, 4097)],
        "moe_buffer": [(e, c, 64) for e in (8, 16, 3) for c in (1, 2, 16, 48, 256, 258)],
        "other": [(8, 8)], "residual ": [(8,)],
    }
    tmesh = Mesh(*mesh_key)
    for rules_kw in ({}, {"fsdp": ("pod", "data")} if "pod" in mesh_key[1]
                     else {"fsdp": "model", "tensor": "data"}):
        con = tact.mesh_constrainer(tmesh, tsh.ShardRules(**rules_kw), 8)
        for kind, kshapes in shapes.items():
            kind = kind.strip()
            for shape in kshapes:
                try:
                    ref = _ref_constraint_spec(mesh_key, rules_kw, 8, shape, kind, monkeypatch)
                except ValueError:  # (fsdp tuple, tensor): a nested tuple, in both
                    with pytest.raises(ValueError, match="nest"):
                        con.spec(shape, kind)
                    continue
                spec = con.spec(shape, kind)
                assert (None if spec is None else tuple(spec)) == ref, (kind, shape, rules_kw)
                x = torch.empty(shape, device="meta")
                try:  # the reference pins specs that may not divide (fsdp tuples)
                    fits = spec is None or tsh.NamedSharding(tmesh, spec).shard_shape(shape)
                except ValueError:
                    fits = False
                if fits:
                    assert con(x, kind) is x
                else:
                    with pytest.raises(ValueError, match="divisible"):
                        con(x, kind)
        assert all(con.spec(s, k) == spec for k, s, spec in con.records)


def _records(use, call):
    got = []
    with use(lambda x, kind: got.append((kind, tuple(x.shape))) or x):
        call()
    return got


@pytest.mark.parametrize("scan", [False, True])
def test_models_constrain_at_the_reference_sites(scan):
    """The forward pins the same (kind, shape) at the same sites: the
    embedding's output, every layer's output and the logits (a scanned
    reference traces its period body once, so there the kinds and shapes
    are compared as a set)."""
    jcfg, jparams, cfg, params = twin_models("yi-6b", n_layers=2, scan_layers=scan)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    ref = _records(jact.use_constrainer,
                   lambda: j_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}))
    got = _records(tact.use_constrainer,
                   lambda: forward(params, cfg, {"tokens": torch.from_numpy(toks)}))
    assert {k for k, _ in got} == {"residual", "logits"}
    if scan:
        assert set(got) == set(ref)
    else:
        assert got == ref


def test_moe_constrains_tokens_flat_as_the_reference():
    """More tokens than a group: the MoE output rows are pinned once."""
    jcfg = j_smoke_config(j_get_config("mixtral-8x22b"))
    cfg = smoke_config(get_config("mixtral-8x22b"))
    x = np.random.default_rng(1).standard_normal((1, tffn.TOKEN_GROUP + 40, 128), np.float32)
    jp = jffn.init_moe_ffn(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = tffn.init_moe_ffn(cfg, torch.float32, torch.Generator().manual_seed(0), "cpu")
    ref = _records(jact.use_constrainer, lambda: jffn.moe_ffn(jp, jnp.asarray(x), jcfg))
    got = _records(tact.use_constrainer, lambda: tffn.moe_ffn(tp, torch.from_numpy(x), cfg))
    assert got == ref == [("tokens_flat", (tffn.TOKEN_GROUP + 40, 128))]


def test_no_constrainer_is_the_identity():
    x = torch.ones(3, 4)
    assert tact.constrain(x, "residual") is x


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", all_archs())
def test_input_specs_match_reference(arch, monkeypatch):
    """Shapes and dtypes of every input of every supported cell, as the
    reference's ``eval_shape`` gives them (its ``input_specs`` is the dict
    of these parts; yi-6b's decode cell is also held to it whole)."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    trees = _trees(arch)
    # input_specs composes the parts held to the reference above; they are
    # taken built, so each cell checks the composition
    monkeypatch.setattr(tsteps, "params_specs", lambda c: trees["params"][1])
    monkeypatch.setattr(tsteps, "opt_specs", lambda c: trees[f"opt_{c.opt_moments}"][1])
    ref_parts = {"params": _ref_flat(trees["params"][0])}
    for name, shape in SHAPES.items():
        if not supports_shape(jcfg, J_SHAPES[name])[0]:
            continue
        got = tsteps.input_specs(cfg, shape)
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            ref_parts["opt_state"] = _ref_flat(trees[f"opt_{jcfg.opt_moments}"][0])
            ref = {"params": ref_parts["params"], "opt_state": ref_parts["opt_state"],
                   "batch": _ref_flat(jsteps.batch_specs(jcfg, B, S, "train"))}
        elif shape.kind == "prefill":
            ref = {"params": ref_parts["params"],
                   "batch": _ref_flat(jsteps.batch_specs(jcfg, B, S, "prefill"))}
        else:
            ref = {"params": ref_parts["params"],
                   "cache": _ref_flat(jsteps.cache_specs(jcfg, B, S)),
                   "tokens": [("", (B, 1), "int32")]}
        assert set(got) == set(ref)
        for k in ref:
            assert _port_flat(got[k]) == ref[k], (arch, name, k)
        assert all(t.device.type == "meta" for _, t in tsh.leaf_paths(got))
    monkeypatch.undo()
    if arch == "yi-6b":
        whole = jsteps.input_specs(jcfg, J_SHAPES["decode_32k"])
        got = tsteps.input_specs(cfg, SHAPES["decode_32k"])
        assert {k: _ref_flat(v) for k, v in whole.items()} == \
            {k: _port_flat(v) for k, v in got.items()}
