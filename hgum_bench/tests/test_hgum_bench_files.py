"""The benchmark's files: found by name, reproducible traffic, the frozen
codec and FLOP counts, the import rules, and run.py's refusals."""
from __future__ import annotations

import ast
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Iterable

import numpy as np
import pytest

from hgum_bench import cells, flops, traffic
from hgum_bench.reference import codec

from .tiny import BENCH, SRC, copy_bench, make_tree

CHECKOUT = BENCH.parent
CELLS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
#: the cells that accepted PRs measure, first in BENCHMARK.json and in this
#: order.  Only a `benchmark` PR changes it.
ACCEPTED = ["mixtral-8x22b.batched.offline", "yi-6b.batched.offline"]
#: cells whose files are there and run but that wait for a bound (PERF.md,
#: Open questions).  Only a `benchmark` PR changes it.
WAITING = {"yi-6b.stream.chat"}


def check_benchmark(bench: dict, root: Path, unlisted: Iterable[str] = WAITING) -> None:
    """``bench``, the dict of BENCHMARK.json, against the benchmark's tree
    ``root``: the accepted cells first and in order; every workload file a
    cell of ``bench`` or one of ``unlisted``, once; every configuration
    file in ``bench`` or used by an unlisted cell; each cell's
    configuration, traffic, chips, why and metrics as its files name them;
    and every cell that reports a per-layer metric reports what it moves."""
    listed = [w["name"] for w in bench["workloads"]]
    assert listed[:len(ACCEPTED)] == ACCEPTED, f"the accepted cells first, in order: {listed}"
    unlisted = sorted(unlisted)
    files = sorted(p.stem for p in (root / "workloads").glob("*.json"))
    assert sorted(listed + unlisted) == files, f"a workload file each, once: {listed} {files}"
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and set(names) == {w["config"] for w in bench["workloads"]}
    waiting = {cells.load(n, root).workload["config"] for n in unlisted}
    assert set(names) | waiting == {p.stem for p in (root / "configs").glob("*.json")}
    for c in bench["configs"]:
        assert c["file"] == f"{BENCH.name}/configs/{c['name']}.json"
        assert (root / "configs" / f"{c['name']}.json").is_file()
    for w in bench["workloads"]:
        cell = cells.load(w["name"], root)
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell.workload["config"], cell.workload["traffic"], cell.workload["chips"],
            cell.workload["why"])
        e2e = {m["name"] for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])}
        assert e2e == set(cell.end_to_end)
        per = {m["name"] for m in bench["per_layer"] if w["name"] in m["workloads"]}
        assert per == set(cell.per_layer)
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= set(listed), m["name"]
        for w in m["workloads"]:  # every cell that reports it reports what it moves
            assert m["moves"] in cells.load(w, root).end_to_end


def test_benchmark_json_names_the_cells_in_order():
    check_benchmark(json.loads((CHECKOUT / "BENCHMARK.json").read_text()), BENCH)


def _without_yi(bench: dict, root: Path) -> None:
    name = "yi-6b.batched.offline"
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != name]
    for m in bench["per_layer"]:
        m["workloads"] = [w for w in m["workloads"] if w != name]
    (root / "workloads" / f"{name}.json").unlink()


def _swapped(bench: dict, root: Path) -> None:
    bench["workloads"][:2] = bench["workloads"][1::-1]


def _unlisted_file(bench: dict, root: Path) -> None:
    w = json.loads((root / "workloads" / "yi-6b.batched.offline.json").read_text())
    w["name"] = "yi-6b.batched.other"
    (root / "workloads" / f"{w['name']}.json").write_text(json.dumps(w))


@pytest.mark.parametrize("change,refusal", [
    (_without_yi, "the accepted cells first"), (_swapped, "the accepted cells first"),
    (_unlisted_file, "a workload file each")])
def test_check_benchmark_refuses(tmp_path, change, refusal):
    """Nothing was loosened: dropping or reordering an accepted cell, or a
    workload file that neither BENCHMARK.json nor ``WAITING`` lists, fails."""
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    root = copy_bench(tmp_path)
    check_benchmark(bench, root)
    change(bench, root)
    with pytest.raises(AssertionError, match=refusal):
        check_benchmark(bench, root)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = cells.load(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.mix["name"] == cell.workload["traffic"]
    assert hasattr(cell.plane, "Plane") and isinstance(cell.plane.STREAMED, bool)
    for mod in list(cell.end_to_end.values()) + list(cell.per_layer.values()):
        assert callable(mod.read) and 1 <= len(mod.UNIT) <= 16


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_is_a_new_file(tmp_path):
    root = copy_bench(tmp_path)
    before = _digest(root)
    new = dict(json.loads((root / "workloads" / "yi-6b.batched.offline.json").read_text()),
               name="yi-6b.stream.offline", traffic="stream.chat")
    (root / "workloads" / "yi-6b.stream.offline.json").write_text(json.dumps(new))
    cell = cells.load("yi-6b.stream.offline", root)
    assert cell.mix["name"] == "stream.chat" and cell.config["name"] == "yi-6b"
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"workloads/yi-6b.stream.offline.json"}


def test_missing_files_are_refused(tmp_path):
    root = make_tree(tmp_path)
    w = json.loads((root / "workloads" / "tiny-dense.batched.json").read_text())
    (root / "workloads" / "bad.json").write_text(json.dumps(dict(w, name="bad",
                                                                 per_layer=["no_such"])))
    with pytest.raises(FileNotFoundError):
        cells.load("bad", root)
    with pytest.raises(ValueError):
        cells.load("tiny-dense.batched", root).workload and cells._json(
            root / "workloads" / "tiny-dense.batched.json", "other")


@pytest.mark.parametrize("name", ["stream.chat", "batched.offline"])
def test_traffic_reproducible_from_seed(name):
    mix = traffic.load(name)
    big = 2 ** 31 + 12345
    a = traffic.wires(traffic.call(mix, 16, 64000, big, 3))
    assert a == traffic.wires(traffic.call(mix, 16, 64000, big, 3))
    b = traffic.call(mix, 16, 64000, big + 1, 3)
    assert a != traffic.wires(b)
    lens = lambda reqs: sorted(len(p) for _, ps in reqs for p in ps)  # noqa: E731
    # every seed and call does the same work: the same lengths, reordered
    assert lens(traffic.call(mix, 16, 64000, big, 3)) == lens(b) == lens(
        traffic.call(mix, 16, 64000, 7, 0))
    flat = [len(p) for _, ps in b for p in ps]
    assert flat != sorted(flat)
    assert min(flat) >= mix["prompt_len"]["lo"] and max(flat) <= mix["pad_to"]
    assert all(2 <= t < 64000 for _, ps in b for p in ps for t in p)


def test_length_distributions():
    u = traffic.lengths({"dist": "uniform", "lo": 16, "hi": 256}, 64)
    assert u[0] == 17 and u[-1] == 255 and abs(u.mean() - 136) < 1
    g = traffic.lengths({"dist": "loguniform", "lo": 64, "hi": 1024}, 64)
    assert g[0] == 65 and g[-1] == 1002 and abs(g.mean() - 346) < 4


def test_codec_equals_the_program():
    from repro_torch.launch import serve

    rng = np.random.default_rng(0)
    for n in (0, 1, 4):
        prompts = [rng.integers(0, 2 ** 31, rng.integers(0, 40)) for _ in range(n)]
        rid = int(rng.integers(0, 2 ** 62))
        wire = codec.encode_request(rid, prompts)
        assert wire == serve.encode_request(rid, [list(map(int, p)) for p in prompts])
        assert codec.decode_request(wire) == (rid, [list(map(int, p)) for p in prompts])
        assert serve.decode_request(wire) == (rid, [list(map(int, p)) for p in prompts])
        outs = [list(map(int, rng.integers(0, 64000, rng.integers(0, 9)))) for _ in range(n)]
        resp = serve.encode_response(rid, outs)
        assert resp == codec.encode_response(rid, outs)
        assert codec.decode_response(resp) == (rid, outs)
    with pytest.raises(ValueError):
        codec.decode_response(resp[1:])
    with pytest.raises(ValueError):
        codec.decode_response(resp[:-1])


def _hand_flops_yi(P, G):
    d, L, ff, V, nq, nkv, hd = 4096, 32, 11008, 64000, 32, 4, 128
    per_tok = 2 * L * (d * d + 2 * d * nkv * hd + d * d + 3 * d * ff)
    n = P + G - 1
    return n * per_tok + L * 4 * nq * hd * n * (n + 1) / 2 + 2 * d * V * G


def test_flops_hand_count_yi():
    cfg = json.loads((BENCH / "configs" / "yi-6b.json").read_text())
    for P, G in ((100, 32), (1, 1), (1024, 128)):
        assert flops.sequence_flops(cfg, P, G) == pytest.approx(_hand_flops_yi(P, G), rel=1e-12)
    # 5.54e9 weights outside the embedding and the head: 11.07 GFLOP a token
    assert flops.token_matmul_flops(cfg) == pytest.approx(2 * 32 * 173015040, rel=1e-12)


def test_flops_hand_count_mixtral():
    cfg = json.loads((BENCH / "configs" / "mixtral-8x22b.json").read_text())
    d, L, ff, V, nq, nkv, hd, E, k = 6144, 7, 16384, 32768, 48, 8, 128, 8, 2
    attn = 6144 * 6144 * 2 + 2 * 6144 * 1024
    assert attn == d * nq * hd * 2 + 2 * d * nkv * hd
    per_tok = 2 * L * (attn + k * 3 * d * ff + d * E)
    P, G = 346, 128
    n = P + G - 1
    hand = n * per_tok + L * 4 * nq * hd * n * (n + 1) / 2 + 2 * d * V * G
    assert flops.sequence_flops(cfg, P, G) == pytest.approx(hand, rel=1e-12)
    windowed = dict(cfg, sliding_window=100)
    ctx = 100 * 101 / 2 + (n - 100) * 100
    assert flops.attention_flops(windowed, n) == pytest.approx(L * 4 * nq * hd * ctx)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_import_rules():
    jax_names = {"jax", "jaxlib", "flax", "repro"}
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & jax_names, (p, tops & jax_names)
        if "reference" in p.parts:
            assert "repro_torch" not in tops, p
    # top-level names compare whole: repro_torch is not repro
    assert {m.split(".")[0] for m in ["repro_torch.launch.serve"]}.isdisjoint(jax_names)


def test_run_forbids_loaded_jax_names():
    run_py = cells.load_module(BENCH / "run.py")
    assert run_py.forbidden_modules(["repro_torch", "repro_torch.launch.serve", "torch",
                                     "jaxtyping", "reproducer"]) == []
    assert run_py.forbidden_modules(["repro_torch", "repro.core.vectorized"]) == ["repro"]
    assert run_py.forbidden_modules(["jax.numpy", "flax", "jaxlib"]) == ["flax", "jax", "jaxlib"]


def _run_py(cwd: Path, script: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script), "--workload", "yi-6b.stream.chat",
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_run_exits_nonzero_without_a_card():
    p = _run_py(CHECKOUT, BENCH / "run.py")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_exits_nonzero_without_the_program(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "hgum_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path, tmp_path / "hgum_bench" / "run.py")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert SRC.is_dir() and not (tmp_path / "src").exists()


def test_weights_are_made_from_the_seed():
    from hgum_bench.reference import weights

    cfg = json.loads((BENCH / "configs" / "yi-6b.json").read_text())
    small = dict(cfg, hidden_size=64, intermediate_size=96, num_attention_heads=4,
                 num_key_value_heads=2, num_hidden_layers=2, vocab_size=300)
    a = weights.make(small, 2 ** 40 + 1, "cpu")
    b = weights.make(small, 2 ** 40 + 1, "cpu")
    c = weights.make(small, 2 ** 40 + 2, "cpu")
    assert set(a) == {n for n, *_ in weights.spec(small)}
    assert all(a[n].equal(b[n]) for n in a)
    assert not a["layers.0.attn.wq"].equal(c["layers.0.attn.wq"])
    assert a["embed"].shape == (384, 64) and a["lm_head"].shape == (64, 384)
    assert float(a["layers.1.ffn.wi"].float().std()) == pytest.approx(64 ** -0.5, rel=0.1)
    assert float(a["layers.0.ln1.scale"].abs().sum()) == 0.0
    assert math.isclose(float(a["embed"].float().std()), 0.02, rel_tol=0.1)
