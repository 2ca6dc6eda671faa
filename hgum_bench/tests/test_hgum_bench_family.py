"""A configuration's reference family: the default is the decoder's own
functions, a new family is a new file, and the test family
``tiny_interleaved`` (MoE on odd layers only) equals the program, runs a
cell end to end, and fails under the faults of the batched cells."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from dataclasses import replace
from unittest import mock

import pytest
import torch

from hgum_bench import cells, flops, harness
from hgum_bench.reference import model as ref_model
from hgum_bench.reference import weights

from . import test_hgum_bench_harness as harness_tests
from .test_hgum_bench_files import _digest
from .tiny import BENCH, CONFIGS, FAMILY, SRC, make_tree, run

SHIPPED = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))
DEFAULT = SHIPPED + ["tiny-dense", "tiny-moe", "tiny-dense-bf16"]
CELL = "tiny-interleaved.batched"


def _config(name: str) -> dict:
    if name in CONFIGS:
        return json.loads(json.dumps(CONFIGS[name]))
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _program_config_before_families(config: dict):
    """``harness.program_config`` as it read before configurations could
    name a family."""
    from repro_torch.configs import get_config

    m = weights.dims(config)
    kw = dict(n_layers=m["L"], d_model=m["d"], n_heads=m["nq"], n_kv=m["nkv"],
              head_dim=config.get("head_dim"), d_ff=m["ff"], vocab=m["V"],
              norm="rmsnorm", norm_eps=m["eps"], rope_theta=m["theta"], act="swiglu",
              tie_embeddings=m["tied"], window=m["window"], dtype=config["torch_dtype"],
              moe_experts=m["E"], local_global_alternate=False, attn_softcap=None,
              final_softcap=None, embed_scale=False, sandwich_norm=False,
              layer_pattern="attn", family="lm")
    if m["E"]:
        kw.update(moe_topk=m["k"], capacity_factor=m["cf"], moe_dff=None, moe_every=1,
                  moe_offset=0)
    return replace(get_config(config["arch"]), **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("hgum_bench_family"))


@pytest.fixture(scope="module")
def family(root):
    return cells.load_family(CONFIGS["tiny-interleaved"], root)


@pytest.mark.parametrize("name", DEFAULT)
def test_default_family_is_todays_code(name):
    config = _config(name)
    assert "family" not in config
    fam = cells.load_family(config)
    assert fam.dims is weights.dims
    assert fam.spec is weights.spec
    assert fam.forward is ref_model.forward
    assert fam.sequence_flops is flops.sequence_flops
    assert fam.program_overrides is weights.decoder_overrides
    before = _program_config_before_families(config)
    assert harness.program_config(config) == before
    assert harness.program_config(config, fam) == before
    if name in SHIPPED:
        for wl in (BENCH / "workloads").glob(f"{name}.*.json"):
            got = cells.load(wl.stem).family
            assert (got.dims, got.spec, got.forward, got.sequence_flops,
                    got.program_overrides) == (fam.dims, fam.spec, fam.forward,
                                               fam.sequence_flops, fam.program_overrides)


def test_a_new_family_is_a_new_file(tmp_path):
    root = tmp_path / "bench"
    for d in ("planes", "metrics", "end_to_end", "traffic", "configs", "workloads"):
        shutil.copytree(BENCH / d, root / d)
    before = _digest(root)
    (root / "families").mkdir()
    shutil.copy(FAMILY, root / "families" / "tiny_interleaved.py")
    (root / "configs" / "tiny-interleaved.json").write_text(json.dumps(CONFIGS["tiny-interleaved"]))
    wl = dict(json.loads((root / "workloads" / "mixtral-8x22b.batched.offline.json").read_text()),
              name="tiny-interleaved.batched.offline", config="tiny-interleaved")
    (root / "workloads" / f"{wl['name']}.json").write_text(json.dumps(wl))
    cell = cells.load(wl["name"], root)
    assert cell.config["family"] == "tiny_interleaved"
    assert cell.family.__file__ == str(root / "families" / "tiny_interleaved.py")
    assert all(callable(getattr(cell.family, f)) for f in cells.FAMILY_FUNCTIONS)
    assert cell.family.forward is not ref_model.forward
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"families/tiny_interleaved.py",
                                        "configs/tiny-interleaved.json",
                                        f"workloads/{wl['name']}.json"}


def test_a_family_lacking_a_function_is_refused(tmp_path):
    (tmp_path / "families").mkdir()
    src = FAMILY.read_text().replace("def sequence_flops(", "def _sequence_flops(")
    (tmp_path / "families" / "partial.py").write_text(src)
    with pytest.raises(ValueError, match="sequence_flops"):
        cells.load_family(dict(CONFIGS["tiny-interleaved"], family="partial"), tmp_path)
    with pytest.raises(FileNotFoundError):
        cells.load_family(dict(CONFIGS["tiny-interleaved"], family="no_such"), tmp_path)


def test_family_import_rules():
    """A family imports nothing of the program and nothing of JAX, also
    through what it imports, and reaches the decoder's pieces through the
    reference layer, not through the timing harness."""
    forbidden = {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    files = [FAMILY] + sorted((BENCH / "families").glob("*.py"))
    for path in files:
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                tops.add(node.module.split(".")[0])
        assert not tops & forbidden, (path, tops & forbidden)
        code = ("import json, pathlib, sys; from hgum_bench import cells; "
                f"cells.load_module(pathlib.Path({str(path)!r})); "
                "print(json.dumps(sorted(sys.modules)))")
        p = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                           text=True, timeout=120, env={"PYTHONPATH": f"{BENCH.parent}:{SRC}",
                                                        "PATH": "/usr/bin:/bin"})
        assert p.returncode == 0, p.stderr
        loaded = set(json.loads(p.stdout))
        assert not {m.split(".")[0] for m in loaded} & forbidden, path
        assert "hgum_bench.harness" not in loaded, path


def test_family_reference_equals_the_program_with_drops(family):
    cfg = dict(CONFIGS["tiny-interleaved"], capacity_factor=0.5)
    W = weights.make(cfg, 3, "cpu", family.spec)
    pcfg = harness.program_config(cfg, family)
    assert pcfg.ffn_kinds() == ("dense", "moe", "dense", "moe")
    params = harness.program_params(pcfg, W)
    toks = torch.randint(2, cfg["vocab_size"], (3, 12), generator=torch.Generator().manual_seed(1))
    from repro_torch.models.model import forward

    with torch.no_grad():
        port, _, aux = forward(params, pcfg, {"tokens": toks.to(torch.int32)})
    assert float(aux["moe_dropped"]) > 0  # the capacity rule is exercised
    m = family.dims(cfg)
    n = toks.numel()
    groups = [(torch.arange(n), ref_model.moe_capacity(n, m["E"], m["k"], m["cf"]))]
    ref = family.forward(W, cfg, toks, 0, groups)
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-4)
    dropless = family.forward(W, cfg, toks, 0, [(torch.arange(n), n * m["k"])])
    assert (dropless - port).abs().max() > 1e-2


@pytest.mark.parametrize("trace", [False, True])
def test_family_sound_run_is_correct(root, trace):
    out = run(root, CELL, seed=2 ** 31 + 13, trace=trace, seconds=0.2)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert set(out["metrics"]) == ({"decode_step_ms"} if trace else {"tokens_per_s", "setup_s"})


def test_family_useful_flops_are_the_familys(root, family):
    seen = []

    def counted(config, prompt_len, generated):
        seen.append((prompt_len, generated))
        return family.sequence_flops(config, prompt_len, generated)
    cell = cells.load(CELL, root)
    with mock.patch.object(cell.family, "sequence_flops", counted):
        from hgum_bench.harness import run_cell

        run_cell(cell, 7, 0.0, False, 0.0, device="cpu")
    assert seen and all(g == cell.mix["max_new"] for _, g in seen)


@pytest.mark.parametrize("fault", [
    "test_fault_half_the_slots_decoded_wrong", "test_fault_step_returns_its_state_unchanged",
    "test_fault_half_the_batch_left_out", "test_fault_token_altered_where_produced"])
def test_family_fault_is_not_correct(root, fault):
    getattr(harness_tests, fault)(root, CELL)


def test_family_flops_hand_count(family):
    cfg = CONFIGS["tiny-interleaved"]
    d, L, ff, V, nq, nkv, hd, E, k = 64, 4, 96, 256, 4, 2, 16, 4, 2
    attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    dense, moe = 3 * d * ff, k * 3 * d * ff + d * E
    per_tok = 2 * (L * attn + 2 * dense + 2 * moe)  # layers 0, 2 dense; 1, 3 MoE
    for P, G in ((9, 5), (1, 1), (16, 5)):
        n = P + G - 1
        hand = n * per_tok + L * 4 * nq * hd * n * (n + 1) / 2 + 2 * d * V * G
        assert family.sequence_flops(cfg, P, G) == pytest.approx(hand, rel=1e-12)
    # neither the dense nor the all-MoE decoder's count
    assert family.sequence_flops(cfg, 9, 5) not in (
        flops.sequence_flops(cfg, 9, 5),
        flops.sequence_flops(dict(cfg, num_local_experts=E), 9, 5))
