"""Port parity, the cost analysis and the dry run: ``launch.costanalysis``
against the reference's HLO analyzer, ``model_flops`` for every cell,
``lower_cell``'s steps against the unsharded steps, the dry run's
extension of a layer trace to full depth, and the CLI.

* ``dot_flops`` of the analyzer tests' functions (``tests/test_launch.py``)
  are exact; on the smoke yi-6b's jitted train, prefill and decode steps
  they are within 1 % of the reference's ``analyze(...).dot_flops`` (they
  agree exactly here: both count every attention tile, masked or not, and
  the recomputation of a remat'd layer).
* The reference's ``lower_cell`` raises on this JAX (``ROADMAP.md`` queue
  C: ``test_sharded_train_step_runs``, ``test_serve_step_sharded``), so
  the port's sharded steps are held to its unsharded steps, bit for bit.
* Everything here runs the smoke widths on the CPU; dry-run cells keep the
  registry's shapes (4 K to 32 K tokens) on the ``meta`` device.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_archs, get_config as j_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import steps as jsteps
from repro.launch.dryrun import model_flops as j_model_flops
from repro.launch.hloanalysis import analyze as j_analyze
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import costanalysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import init_cache, init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.sharding import leaf_paths
from torch_parity import twin_configs

MESH = ((2, 2, 2), ("pod", "data", "model"))
#: the smoke widths, as ``--set`` overrides of a registry config
SMOKE = ("d_model", "n_heads", "n_kv", "head_dim", "d_ff", "vocab", "moe_experts", "window",
         "enc_layers", "enc_seq", "vision_tokens", "vision_dim", "ssm_state", "ssm_head")


# ---------------------------------------------------------------------------
# cost analysis
# ---------------------------------------------------------------------------


def test_dot_flops_exact_on_the_analyzer_cases():
    """``tests/test_launch.py``'s functions: ten ``tanh(x @ w)`` (a scan in
    the reference, a loop here), and 3 inside 5; a mesh-axis reduction is
    counted as a collective."""
    x, w = torch.empty((64, 128), device="meta"), torch.empty((128, 128), device="meta")

    def ten(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    _, rep = ca.analyze(ten, x, w)
    assert rep.dot_flops == 2 * 64 * 128 * 128 * 10
    assert rep.flops == rep.dot_flops + 10 * 64 * 128  # tanh: one per element
    assert rep.hbm_bytes == 10 * (64 * 128 * 4 * 2 + 128 * 128 * 4) + 10 * 64 * 128 * 4 * 2

    x2, w2 = torch.empty((32, 64), device="meta"), torch.empty((64, 64), device="meta")

    def nested(x, w):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x

    _, rep = ca.analyze(nested, x2, w2)
    assert rep.dot_flops == 2 * 32 * 64 * 64 * 15
    from repro_torch.runtime.compress import cross_pod_mean_int8

    g = {"w": torch.zeros((4, 8, 128))}
    _, rep = ca.analyze(cross_pod_mean_int8, g, {"w": torch.zeros((4, 8, 128))})
    assert rep.collective_bytes > 0 and rep.collective_count["all-reduce"] == 2
    # views are free, einsum reaches bmm
    _, rep = ca.analyze(lambda a: torch.einsum("bij,bjk->bik", a, a.transpose(1, 2)),
                        torch.empty((3, 4, 5), device="meta"))
    assert rep.dot_flops == 2 * 3 * 4 * 4 * 5


def _ref_step_dot_flops(jcfg, shape):
    specs = jsteps.input_specs(jcfg, shape)
    if shape.kind == "train":
        f, args = jsteps.make_train_step(jcfg, JAdamWConfig()), ("params", "opt_state", "batch")
    elif shape.kind == "prefill":
        f, args = jsteps.make_prefill_step(jcfg), ("params", "batch")
    else:
        f, args = jsteps.make_serve_step(jcfg), ("params", "cache", "tokens")
    text = jax.jit(f).lower(*(specs[a] for a in args)).compile().as_text()
    return j_analyze(text).dot_flops


@pytest.mark.parametrize("kind,microbatch", [("train", 2), ("prefill", 1), ("decode", 1)])
def test_step_dot_flops_match_reference_analyzer(kind, microbatch):
    jcfg, cfg = twin_configs("yi-6b", n_layers=2, microbatch=microbatch)
    ref = _ref_step_dot_flops(jcfg, JShapeConfig("x", 64, 4, kind))
    rep, _ = dryrun._trace(cfg, ShapeConfig("x", 64, 4, kind))
    assert abs(rep.dot_flops - ref) <= 0.01 * ref, (rep.dot_flops, ref)


@pytest.mark.parametrize("arch", all_archs())
def test_model_flops_match_reference(arch):
    for name, shape in SHAPES.items():
        assert dryrun.model_flops(get_config(arch), shape) == \
            j_model_flops(j_get_config(arch), J_SHAPES[name])


# ---------------------------------------------------------------------------
# the dry run's extension to full depth
# ---------------------------------------------------------------------------


def _smoke(arch, **changes):
    return dataclasses.replace(smoke_config(get_config(arch)), **changes)


@pytest.mark.parametrize("arch,kind,changes", [
    ("yi-6b", "train", {"n_layers": 4, "microbatch": 4}),
    ("yi-6b", "prefill", {"n_layers": 4}),
    ("yi-6b", "decode", {"n_layers": 4}),
    ("gemma2-27b", "train", {"n_layers": 6, "microbatch": 1}),
    ("whisper-tiny", "prefill", {"n_layers": 4}),
    ("mixtral-8x22b", "train", {"n_layers": 3, "microbatch": 5}),
])
def test_extended_trace_equals_full_trace(arch, kind, changes):
    """Traces of no layers and one period (and of two and three
    microbatches), extended, give the full trace's counts: exactly, but for
    an MoE train step's flops and bytes, where the balance-loss term a
    layer-less model lacks shows as a few scalar ops a period."""
    cfg = _smoke(arch, **changes)
    shape = ShapeConfig("x", 96, 8 if kind != "train" else 20 if arch == "mixtral-8x22b" else 8,
                        kind)
    got, _ = dryrun.step_cost(cfg, shape)
    full, _ = dryrun._trace(dataclasses.replace(cfg, scan_layers=False), shape)
    assert got.dot_flops == full.dot_flops
    if cfg.moe_experts and kind == "train":
        assert abs(got.flops - full.flops) <= 64 * cfg.n_layers
        assert abs(got.hbm_bytes - full.hbm_bytes) <= 1024 * cfg.n_layers
    else:
        assert (got.flops, got.hbm_bytes) == (full.flops, full.hbm_bytes)


# ---------------------------------------------------------------------------
# lower_cell: the sharded steps are the unsharded steps
# ---------------------------------------------------------------------------


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))
    seg = torch.from_numpy(np.repeat([[1] * (S // 2) + [2] * (S - S // 2)], B, 0).astype(np.int32))
    pos = torch.from_numpy(np.tile(np.r_[np.arange(S // 2), np.arange(S - S // 2)], (B, 1))
                           .astype(np.int32))
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1), "segment_ids": seg,
            "positions": pos, "loss_mask": torch.ones((B, S))}


def _state(cfg, seed=0):
    params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return params, adamw_init(params, cfg.opt_moments)


def test_sharded_train_step_equals_unsharded():
    """The reference's ``test_sharded_train_step_runs`` cell (2 layers,
    2 microbatches, scanned) on the (2,2,2) mesh: two steps' losses and
    every parameter and moment bit for bit the unsharded step's."""
    cfg = _smoke("yi-6b", n_layers=2, microbatch=2, scan_layers=True)
    shape = ShapeConfig("t", 32, 8, "train")
    step, shardings, specs = dryrun.lower_cell(cfg, shape, Mesh(*MESH))
    assert {p for p, _ in leaf_paths(specs["params"])} == \
        {p for p, _ in leaf_paths(shardings["in"][0])}
    plain = make_train_step(cfg, AdamWConfig(moments=cfg.opt_moments))
    (p1, o1), (p2, o2) = _state(cfg), _state(cfg)
    for i in range(2):
        b = _batch(cfg, 8, 32, seed=i)
        p1, o1, m1 = step(p1, o1, b)
        p2, o2, m2 = plain(p2, o2, b)
        assert torch.equal(m1["loss"], m2["loss"]) and np.isfinite(float(m1["loss"]))
    for (n, a), (_, b) in zip(leaf_paths((p1, o1)), leaf_paths((p2, o2))):
        assert torch.equal(a, b), n
    kinds = {k for k, _, _ in step.constrainer.records}
    assert kinds == {"residual", "logits"}


def test_sharded_serve_steps_equal_unsharded():
    """Prefill and decode cells (the reference's ``test_serve_step_sharded``
    shape) on the (2,2,2) mesh: next tokens and caches bit for bit."""
    cfg = _smoke("yi-6b", n_layers=2)
    params, _ = _state(cfg)
    mesh = Mesh(*MESH)
    pstep, _, _ = dryrun.lower_cell(cfg, ShapeConfig("p", 64, 8, "prefill"), mesh)
    batch = {"tokens": _batch(cfg, 8, 64)["tokens"]}
    t1, c1 = pstep(params, batch)
    t2, c2 = make_prefill_step(cfg)(params, batch)
    assert torch.equal(t1, t2)
    for (n, a), (_, b) in zip(leaf_paths(c1), leaf_paths(c2)):
        assert torch.equal(a, b), n
    dstep, shardings, _ = dryrun.lower_cell(cfg, ShapeConfig("d", 64, 8, "decode"), mesh)
    assert shardings["donate"] == (1,)
    cache_a = init_cache(cfg, 8, 64, device="cpu")
    cache_b = init_cache(cfg, 8, 64, device="cpu")
    toks = torch.ones((8, 1), dtype=torch.int32)
    for _ in range(3):
        toks_a, cache_a = dstep(params, cache_a, toks)
        toks_b, cache_b = make_serve_step(cfg)(params, cache_b, toks)
        assert torch.equal(toks_a, toks_b) and toks_a.shape == (8, 1)
        toks = toks_a
    for (n, a), (_, b) in zip(leaf_paths(cache_a), leaf_paths(cache_b)):
        assert torch.equal(a, b), n


def test_sharded_step_rejects_a_layout_that_does_not_fit():
    cfg = _smoke("yi-6b", n_layers=1)
    step, _, _ = dryrun.lower_cell(cfg, ShapeConfig("d", 64, 8, "decode"), Mesh(*MESH))
    params, _ = _state(cfg)
    with pytest.raises(ValueError, match="divisible"):  # batch 6 over pod x data = 4
        step(params, init_cache(cfg, 6, 64, device="cpu"), torch.ones((6, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# cells and the CLI
# ---------------------------------------------------------------------------


def test_dryrun_cli_writes_cells(tmp_path, capsys):
    """yi-6b at smoke widths on both production meshes: the reference's
    JSON keys, the unsupported cell skipped, per-device argument bytes
    exact, the H100's constants."""
    cfg = smoke_config(get_config("yi-6b"))
    sets = [f"{k}={getattr(cfg, k)}" for k in SMOKE if getattr(cfg, k) is not None]
    dryrun.main(["--arch", "yi-6b", "--mesh", "both", "--out", str(tmp_path),
                 "--shape", "decode_32k", "--set", *sets])
    dryrun.main(["--arch", "yi-6b", "--mesh", "single", "--out", str(tmp_path),
                 "--shape", "long_500k", "--no-ep", "--set", *sets])
    out = capsys.readouterr().out
    assert out.count(" ok ") == 2 and "skipped" in out
    r = json.loads((tmp_path / "yi-6b_decode_32k_multi.json").read_text())
    assert r["status"] == "ok" and r["n_chips"] == 512 and r["collective_source"] == "layout"
    assert set(r) >= {"memory", "hlo", "roofline", "scan_layers", "lower_s"}
    mem = r["memory"]
    assert mem["temp_bytes"] is None and mem["fits"] is True
    assert mem["per_device_bytes"] == mem["argument_bytes"] + mem["output_bytes"] - \
        mem["alias_bytes"]
    c = dataclasses.replace(get_config("yi-6b"), **{k: getattr(cfg, k) for k in SMOKE})
    _, shardings, specs = dryrun.lower_cell(c, SHAPES["decode_32k"],
                                            dryrun.make_production_mesh(multi_pod=True))
    want = sum(dryrun.tree_bytes(specs[k], sh)
               for k, sh in zip(("params", "cache", "tokens"), shardings["in"]))
    assert mem["argument_bytes"] == want and mem["alias_bytes"] == \
        dryrun.tree_bytes(specs["cache"], shardings["in"][1])
    assert r["device"]["peak_flops"] == 989e12 and r["device"]["hbm_bytes"] == ca.HBM_BYTES
    rf = r["roofline"]
    assert rf["t_compute"] == r["hlo"]["flops"] / 989e12
    assert rf["model_flops_global"] == dryrun.model_flops(c, SHAPES["decode_32k"])
    skipped = json.loads((tmp_path / "yi-6b_long_500k_single.json").read_text())
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]


def test_layout_collectives():
    """The layout's per-device bytes: no tensor-axis reductions on a mesh
    without the tensor axis; FSDP gathers of every sharded leaf; the train
    step's gradient sums."""
    cfg = _smoke("yi-6b", n_layers=2, microbatch=2)
    shape = ShapeConfig("t", 32, 8, "train")
    rules = dryrun.ShardRules()
    mesh = Mesh((4,), ("data",))
    _, shardings, specs = dryrun.lower_cell(cfg, shape, mesh, rules)
    got = dryrun.layout_collectives(cfg, shape, mesh, rules, shardings, specs)
    assert "all-gather" in got and "reduce-scatter" in got
    n_params = sum(t.numel() for _, t in leaf_paths(specs["params"]))
    sharded = sum(t.numel() for (_, t), (_, sh) in zip(leaf_paths(specs["params"]),
                                                        leaf_paths(shardings["in"][0]))
                  if any(sh.spec))
    # every sharded leaf: 3 of 4 quarters gathered, forward + backward x 2 microbatches
    assert got["all-gather"] == 4 * sharded // 4 * 3 * 4
    assert got["reduce-scatter"] + got.get("all-reduce", 0) / 2 == n_params * 4 * 3 / 4
    mesh = Mesh(*MESH)
    _, shardings, specs = dryrun.lower_cell(cfg, shape, mesh, rules)
    got = dryrun.layout_collectives(cfg, shape, mesh, rules, shardings, specs)
    assert got["all-reduce"] > 0
