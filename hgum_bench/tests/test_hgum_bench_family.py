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
from pathlib import Path
from typing import List
from unittest import mock

import pytest
import torch

from hgum_bench import cells, flops, harness
from hgum_bench.reference import model as ref_model
from hgum_bench.reference import weights

from . import test_hgum_bench_harness as harness_tests
from .test_hgum_bench_files import WAITING, _digest, check_benchmark
from .tiny import BENCH, CONFIGS, FAMILY, SRC, WORKLOADS, copy_bench, make_tree, run


def _config(name: str) -> dict:
    if name in CONFIGS:
        return json.loads(json.dumps(CONFIGS[name]))
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


SHIPPED = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))
#: the shipped configurations that name no family, and the tiny ones
DEFAULT = [n for n in SHIPPED if "family" not in _config(n)] + [
    "tiny-dense", "tiny-moe", "tiny-dense-bf16"]
CELL = "tiny-interleaved.batched"


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


def _cells_of(config: dict, root: Path) -> List[str]:
    return [p.stem for p in sorted((root / "workloads").glob("*.json"))
            if json.loads(p.read_text())["config"] == config["name"]]


def check_default_family(config: dict, root: Path = BENCH) -> None:
    """A configuration that names no family resolves to today's five
    objects, and so does every cell of it in ``root``."""
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
    for name in _cells_of(config, root):
        got = cells.load(name, root).family
        assert (got.dims, got.spec, got.forward, got.sequence_flops,
                got.program_overrides) == (fam.dims, fam.spec, fam.forward,
                                           fam.sequence_flops, fam.program_overrides)


def check_family(config: dict, root: Path = BENCH) -> None:
    """A configuration that names a family loads ``families/<family>.py``
    of ``root`` with the five functions, and every cell of it carries that
    module."""
    path = str(root / "families" / f"{config['family']}.py")
    fam = cells.load_family(config, root)
    assert fam.__file__ == path
    assert all(callable(getattr(fam, f)) for f in cells.FAMILY_FUNCTIONS)
    for name in _cells_of(config, root):
        got = cells.load(name, root).family
        assert got.__file__ == path
        assert all(callable(getattr(got, f)) for f in cells.FAMILY_FUNCTIONS)


@pytest.mark.parametrize("name", DEFAULT)
def test_default_family_is_todays_code(name):
    check_default_family(_config(name))


def test_shipped_family_configurations_load():
    """One test over the shipped configurations that name a family (none
    yet: an empty parametrisation would skip, and a skip is no pass); and
    no shipped family file is left that no configuration names."""
    named = [c for c in map(_config, SHIPPED) if "family" in c]
    assert {c["family"] for c in named} == {p.stem for p in (BENCH / "families").glob("*.py")}
    for config in named:
        check_family(config)


def test_a_new_family_is_a_new_file(tmp_path):
    root = copy_bench(tmp_path)
    before = _digest(root)
    (root / "families").mkdir(exist_ok=True)
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


#: the rehearsal's per-layer reader: generated tokens per measured call
READER = """UNIT = "tokens"


def read(run):
    calls = run.measured_calls()
    return sum(c.tokens for c in calls) / len(calls) if calls else None
"""


def test_a_family_configuration_and_its_cell_are_new_files_and_entries(tmp_path):
    """What a PR that adds a configuration with a family of its own, its
    cell and a reader writes, at a tiny size: new files, entries appended
    to a copy of BENCHMARK.json, and the new cell's name appended to two
    readers' lists.  Every check of the shipped benchmark holds on the
    result, no file that was there changes, and the cell runs correct."""
    root = make_tree(tmp_path)
    before = _digest(root)
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    config = dict(CONFIGS["tiny-interleaved"], name="tiny-hybrid", family="tiny_hybrid")
    cell, metric = "tiny-hybrid.batched", "tokens_per_call"
    why = "a tiny hybrid: MoE on odd layers, 4 wires x 2 prompts of 3-16 tokens a call, 8 slots"
    per_layer = ["device_idle_share", "decode_step_ms", metric]
    wl = dict(json.loads((root / "workloads" / f"{CELL}.json").read_text()), name=cell,
              config=config["name"], why=why, per_layer=per_layer)
    shutil.copy(FAMILY, root / "families" / "tiny_hybrid.py")
    (root / "configs" / "tiny-hybrid.json").write_text(json.dumps(config))
    (root / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    (root / "metrics" / f"{metric}.py").write_text(READER)
    bench["configs"].append({"name": config["name"], "source": "a CPU test",
                             "file": f"{BENCH.name}/configs/tiny-hybrid.json",
                             "reduced": [], "why": "MoE on odd layers"})
    bench["workloads"].append({"name": cell, "config": config["name"], "traffic": wl["traffic"],
                               "chips": 1, "why": why})
    bench["per_layer"].append({"name": metric, "unit": "tokens", "better": "higher",
                               "source": "program_counter", "layer": "a CPU test",
                               "moves": "tokens_per_s", "workloads": [cell]})
    for m in bench["per_layer"]:
        if m["name"] in per_layer[:2]:
            m["workloads"].append(cell)

    check_benchmark(bench, root, WAITING | set(WORKLOADS))
    for path in sorted((root / "configs").glob("*.json")):
        other = json.loads(path.read_text())
        if "family" not in other:
            check_default_family(other, root)
    check_family(config, root)
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "families/tiny_hybrid.py", "configs/tiny-hybrid.json", f"workloads/{cell}.json",
        f"metrics/{metric}.py"}
    for trace in (False, True):
        out = run(root, cell, seed=2 ** 31 + 17, trace=trace, seconds=0.2)
        assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
        # the device's idle share reads nothing on the CPU
        assert set(out["metrics"]) == ({"decode_step_ms", metric} if trace
                                       else {"tokens_per_s", "setup_s"})


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
