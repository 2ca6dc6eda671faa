"""Port parity, serving plane: ``repro_torch.launch.serve`` against the JAX package.

The same request wires and the same (carried-over) parameters go through
both ``serve_requests``; the response wires must be byte-identical, with
more sequences than slots so that eviction and slot reuse run.  Also here:
the scheduler's emission order, the batched request DES, the package's
import isolation (no JAX, nothing of ``repro``) and the absence of a
hidden CPU fallback.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.launch import serve as jserve
from repro.models import init_params as j_init_params
from repro.runtime.scheduler import ContinuousBatcher as JBatcher
from repro.runtime.scheduler import SchedulerConfig as JSched
from repro_torch.configs import get_config, smoke_config
from repro_torch.device import NoCudaError
from repro_torch.launch import serve as tserve
from repro_torch.models import params_from_jax
from repro_torch.runtime.scheduler import ContinuousBatcher, SchedulerConfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jcfg = j_smoke_config(j_get_config("yi-6b"))
    cfg = smoke_config(get_config("yi-6b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _wires(cfg, rng, n_prompts=(2, 0, 3, 1)):
    """Requests with 6 prompts in all (one request has none), 4..20 tokens."""
    return [
        tserve.encode_request(10 + r, [
            list(map(int, rng.integers(2, cfg.vocab, rng.integers(4, 20)))) for _ in range(k)
        ])
        for r, k in enumerate(n_prompts)
    ]


def test_serve_requests_byte_identical(models):
    jcfg, jparams, cfg, tparams = models
    wires = _wires(cfg, np.random.default_rng(0))
    kw = dict(max_new=4, pad_to=16, slots=4)  # 6 sequences > 4 slots
    want = jserve.serve_requests(jparams, jcfg, wires, **kw)
    got = tserve.serve_requests(tparams, cfg, wires, device="cpu", **kw)
    assert got == want
    rid, outs = tserve.decode_response(got[1])
    assert (rid, outs) == (11, [])
    assert [len(o) for o in tserve.decode_response(got[2])[1]] == [4, 4, 4]


def test_serve_request_sequential_byte_identical(models):
    jcfg, jparams, cfg, tparams = models
    wire = _wires(cfg, np.random.default_rng(1), n_prompts=(2,))[0]
    want = jserve.serve_request(jparams, jcfg, wire, max_new=3, pad_to=16)
    assert tserve.serve_request(tparams, cfg, wire, max_new=3, pad_to=16, device="cpu") == want


@pytest.mark.parametrize("admit_cap,max_new", [(None, 4), (2, 1)])
def test_batcher_emissions_same_order(models, admit_cap, max_new):
    """(seq_id, position, token) emissions, tick by tick, in the same order;
    ``admit_cap=2`` leaves unused admit rows whose slot copy is dropped."""
    jcfg, jparams, cfg, tparams = models
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(2, cfg.vocab, rng.integers(4, 20)))) for _ in range(5)]
    kw = dict(slots=3, prompt_cap=16, max_new=max_new, admit_cap=admit_cap)
    jb = JBatcher(jparams, jcfg, JSched(**kw))
    tb = ContinuousBatcher(tparams, cfg, SchedulerConfig(**kw))
    for i, p in enumerate(prompts):
        jb.submit(i, p)
        tb.submit(i, p)
    ticks = 0
    while jb.pending or jb.n_active:
        jb.step_begin()
        tb.step_begin()
        assert tb.step_finish() == jb.step_finish()
        ticks += 1
    assert not (tb.pending or tb.n_active) and ticks > 1
    assert tb.done == jb.done


def test_decode_request_batch_matches_jax():
    rng = np.random.default_rng(3)
    wires = []
    for m, k in enumerate([0, 1, 3, 5, 2, 4]):  # ragged, one empty, empty lists
        prompts = [list(map(int, rng.integers(0, 2**31, rng.integers(0, 9)))) for _ in range(k)]
        wires.append(jserve.encode_request(100 + m, prompts))
    got = tserve.decode_request_batch(wires, "cpu")
    assert got == jserve.decode_request_batch(wires)
    assert got == [jserve.decode_request(w) for w in wires]
    assert got == [tserve.decode_request(w) for w in wires]


def test_cli_smoke_on_cpu(capsys):
    tserve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--n-requests", "2",
                 "--n-prompts", "2", "--max-new", "2", "--pad-to", "8", "--slots", "2"])
    out = capsys.readouterr().out
    assert "batched(slots=2): 2 requests, 8 tokens" in out


# ---------------------------------------------------------------------------
# no hidden fallback, import isolation
# ---------------------------------------------------------------------------


def test_entry_points_default_to_cuda(models):
    _, _, cfg, tparams = models
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    wires = _wires(cfg, np.random.default_rng(4), n_prompts=(1,))
    from repro_torch.models import init_params
    for call in (lambda: tserve.serve_requests(tparams, cfg, wires),
                 lambda: tserve.serve_request(tparams, cfg, wires[0]),
                 lambda: tserve.decode_request_batch(wires),
                 lambda: init_params(cfg)):
        with pytest.raises(NoCudaError, match="device='cpu'"):
            call()


_ISOLATION = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import ast
tree = ast.parse(open({smoke!r}).read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print(len(mods), bad)
assert not bad, bad
assert len(mods) >= 30, mods
"""


def test_import_isolation():
    """Every module of the port and every import of chip_smoke.py loads
    without JAX or the JAX package."""
    code = _ISOLATION.format(src=str(ROOT / "src"), smoke=str(ROOT / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
