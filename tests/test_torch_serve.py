"""Port parity, serving plane: ``repro_torch.launch.serve`` against the JAX package.

The same request wires and the same (carried-over) parameters go through
both ``serve_requests``; the response wires must be byte-identical, with
more sequences than slots so that eviction and slot reuse run.  The
sharded plane (``serve_requests_sharded``, the routed fabric with ARQ,
with and without a shard blackout) must answer with the same bytes as the
reference's sharded plane and the port's batched plane.  Also here: the
scheduler's emission order, the batched request DES, the package's import
isolation (no JAX, nothing of ``repro``) and the absence of a hidden CPU
fallback.
"""
import dataclasses
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


@pytest.fixture(scope="module")
def two_layer_models():
    """The smoke yi-6b cut to 2 layers, both packages, same parameters."""
    jcfg = dataclasses.replace(j_smoke_config(j_get_config("yi-6b")), n_layers=2)
    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")), n_layers=2)
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
# sharded plane: the routed fabric between ingress and shards
# ---------------------------------------------------------------------------

_SHARD_KW = dict(max_new=4, pad_to=8, slots=4)


def _shard_wires(cfg):
    r = np.random.default_rng(0)
    return [tserve.encode_request(i, [list(map(int, r.integers(2, cfg.vocab, 12)))
                                      for _ in range(2)]) for i in range(4)]


def test_serve_requests_sharded_byte_identical(two_layer_models):
    """n_shards=3 with ARQ (the serving default): the same bytes as the
    reference's sharded plane and as the port's batched plane."""
    jcfg, jparams, cfg, tparams = two_layer_models
    wires = _shard_wires(cfg)
    base = tserve.serve_requests(tparams, cfg, wires, device="cpu", **_SHARD_KW)
    want = jserve.serve_requests_sharded(jparams, jcfg, wires, n_shards=3, **_SHARD_KW)
    fab = tserve.default_serve_fabric(3, device="cpu")
    got = tserve.serve_requests_sharded(tparams, cfg, wires, fabric=fab, device="cpu",
                                        **_SHARD_KW)
    assert got == want == base
    assert fab.n_ranks == 4 and fab.config.arq and fab.config.frame_phits == 16
    assert fab.frames_routed > 0 and fab.load_drift() == {}


def test_sharded_blackout_completes(two_layer_models):
    """Shard 2 goes dark from tick 1 (its responses never arrive): the
    ingress suspects it, re-places its requests once, and the answers stay
    byte-identical — as in the reference, with the same recovery counters."""
    from repro.fabric import FaultPlan as JFaultPlan
    from repro_torch.fabric import FaultPlan

    jcfg, jparams, cfg, tparams = two_layer_models
    wires = _shard_wires(cfg)
    plan = dict(seed=7, blackout_rank=2, blackout_from=1, blackout_ticks=1 << 20)
    kw = dict(placement=[1, 2, 3, 2], suspect_after=8, **_SHARD_KW)
    jfab = jserve.default_serve_fabric(3, faults=JFaultPlan(**plan))
    want = jserve.serve_requests_sharded(jparams, jcfg, wires, fabric=jfab, **kw)
    fab = tserve.default_serve_fabric(3, faults=FaultPlan(**plan), device="cpu")
    got = tserve.serve_requests_sharded(tparams, cfg, wires, fabric=fab, device="cpu", **kw)
    assert got == want
    assert got == tserve.serve_requests(tparams, cfg, wires, device="cpu", **_SHARD_KW)

    def counters(f):
        return {m["name"]: m["value"] for m in f.metrics.snapshot()["metrics"]
                if m["type"] == "counter" and m["name"].startswith(("serve.", "fabric.arq."))}

    assert counters(fab) == counters(jfab)
    assert counters(fab)["serve.suspects"] >= 1 and counters(fab)["serve.retries"] >= 1
    assert fab.ticks == jfab.ticks
    np.testing.assert_array_equal(fab.counters_total(), jfab.counters_total())


def test_sharded_with_one_rank_is_the_batched_plane(two_layer_models):
    _, _, cfg, tparams = two_layer_models
    from repro_torch.fabric import Fabric

    wires = _shard_wires(cfg)[:2]
    got = tserve.serve_requests_sharded(tparams, cfg, wires, device="cpu",
                                        fabric=Fabric(n_ranks=1, device="cpu"), **_SHARD_KW)
    assert got == tserve.serve_requests(tparams, cfg, wires, device="cpu", **_SHARD_KW)
    from repro_torch.obs import TraceRecorder

    trace = TraceRecorder()
    got = tserve.serve_requests_sharded(tparams, cfg, wires, device="cpu", analyze=True,
                                        trace=trace, fabric=Fabric(n_ranks=1, device="cpu"),
                                        **_SHARD_KW)
    assert got == tserve.serve_requests(tparams, cfg, wires, device="cpu", **_SHARD_KW)
    assert trace.events == []  # no fabric tick: the batched plane, as in the reference


def test_cli_sharded_on_cpu(capsys):
    tserve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--n-requests", "3",
                 "--n-prompts", "2", "--max-new", "2", "--pad-to", "8", "--slots", "2",
                 "--sharded", "--n-shards", "3", "--chaos", "drop=0.05", "--routing",
                 "dimension"])
    out = capsys.readouterr().out
    assert "sharded(slots=2): 3 requests, 12 tokens" in out
    assert "[serve] fabric: 4 ranks" in out


# ---------------------------------------------------------------------------
# no hidden fallback, import isolation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_streaming_serve_packs_each_tick_in_one_call(two_layer_models, monkeypatch, overlap):
    """``--streaming --n-shards 3 --logprobs`` on the CPU: the same bytes as
    the batched plane, with every lane of a tick (token and logprob lanes
    of three shards) packed by one ``encode_fragment_bursts`` call, at most
    one per tick plus the drain; the per-lane encoders never run."""
    from repro_torch.stream import plane

    _, _, cfg, tparams = two_layer_models
    wires = _shard_wires(cfg)
    base = tserve.serve_requests(tparams, cfg, wires, device="cpu", **_SHARD_KW)
    calls = []
    inner = plane.encode_fragment_bursts

    def counted(items, device=None):
        calls.append(len(items))
        return inner(items, device)

    def refuse(*a, **k):
        raise AssertionError("a lane was encoded on its own")

    monkeypatch.setattr(plane, "encode_fragment_bursts", counted)
    monkeypatch.setattr(plane, "encode_fragment_burst", refuse)
    monkeypatch.setattr(plane, "encode_chunk_burst", refuse)
    fab = tserve.default_serve_fabric(3, device="cpu")
    got = tserve.serve_requests_streaming(tparams, cfg, wires, fabric=fab, logprobs=True,
                                          overlap=overlap, device="cpu", **_SHARD_KW)
    assert got == base
    assert 1 <= len(calls) <= fab.ticks + 1 and max(calls) >= 2


def test_entry_points_default_to_cuda(models):
    _, _, cfg, tparams = models
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    wires = _wires(cfg, np.random.default_rng(4), n_prompts=(1,))
    from repro_torch.core.stream_plans import encode_fragment_burst
    from repro_torch.fabric import Fabric, Router
    from repro_torch.models import init_params
    from repro_torch.stream import (ChunkLane, TokenChunk, encode_chunk_burst,
                                    logprob_stream_plan)
    for call in (lambda: tserve.serve_requests(tparams, cfg, wires),
                 lambda: tserve.serve_request(tparams, cfg, wires[0]),
                 lambda: tserve.decode_request_batch(wires),
                 lambda: init_params(cfg),
                 lambda: Fabric(n_ranks=4),
                 lambda: Router((4,)),
                 lambda: tserve.default_serve_fabric(3),
                 lambda: tserve.serve_requests_sharded(tparams, cfg, wires, n_shards=3),
                 lambda: tserve.main(["--arch", "yi-6b", "--smoke", "--sharded"]),
                 lambda: tserve.serve_requests_streaming(tparams, cfg, wires, n_shards=3),
                 lambda: encode_chunk_burst([TokenChunk(1, 0, (5,))]),
                 lambda: encode_fragment_burst(logprob_stream_plan(), [TokenChunk(1, 0, ())]),
                 lambda: ChunkLane(Fabric(n_ranks=2).mailbox(1), 0),
                 lambda: tserve.main(["--arch", "yi-6b", "--smoke", "--streaming"])):
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
new = {{"repro_torch.fabric.frames", "repro_torch.fabric.router",
        "repro_torch.fabric.mailbox", "repro_torch.fabric.faults",
        "repro_torch.kernels.frame_pack", "repro_torch.analysis.comm",
        "repro_torch.analysis.rules", "repro_torch.obs.counters",
        "repro_torch.obs.metrics", "repro_torch.stream", "repro_torch.stream.chunks",
        "repro_torch.stream.plane", "repro_torch.core.stream_plans",
        "repro_torch.obs.trace", "repro_torch.obs.spans", "repro_torch.obs.report",
        "repro_torch.obs.slo", "repro_torch.obs.__main__",
        "repro_torch.analysis.schema_passes", "repro_torch.analysis.config_passes",
        "repro_torch.analysis.fabric_passes", "repro_torch.analysis.targets",
        "repro_torch.analysis.__main__", "repro_torch.models.ssm",
        "repro_torch.models.ffn", "repro_torch.models.model", "repro_torch.optim.adamw",
        "repro_torch.optim.microbatch", "repro_torch.data.pipeline",
        "repro_torch.data.prefetch", "repro_torch.checkpoint.store",
        "repro_torch.launch.train", "repro_torch.runtime.sharding",
        "repro_torch.runtime.actshard", "repro_torch.runtime.pipeline",
        "repro_torch.runtime.channels", "repro_torch.runtime.compress",
        "repro_torch.launch.mesh", "repro_torch.launch.costanalysis",
        "repro_torch.launch.dryrun"}}
assert new <= set(mods), new - set(mods)
"""


def test_import_isolation():
    """Every module of the port (the fabric, its frame kernels, the stream
    plane, the copied stream codec, analysis and obs modules, the model
    families' MoE and SSM blocks, the training side and the multi-device
    drivers included) and every import of chip_smoke.py loads without JAX
    or the JAX package."""
    code = _ISOLATION.format(src=str(ROOT / "src"), smoke=str(ROOT / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
