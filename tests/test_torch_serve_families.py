"""Port parity, serving the model families: ``serve_requests`` of the port
against the JAX package's for mixtral, phi3.5-moe, gemma2, jamba, xlstm,
granite-34b (multi-query attention: one K/V head for every query head, the
2-matrix gelu MLP) and stablelm-3b (full multi-head attention).

The same request wires and the same (carried-over) parameters of each
architecture's float32 ``smoke_config`` (gemma2 and xlstm cut to 2 layers,
jamba to 5) go through both packages; the response wires must be
byte-identical, with more sequences than slots, so that eviction and slot
reuse run through the SSM states and idle slots take MoE capacity.  The
sliding window's ring is reached by a prompt as long as the window.
xlstm's sharded plane (no capacity-bounded routing, so placement cannot
change an answer) must equal the reference's sharded plane and the port's
batched plane.  The serve CLI takes every one of these architectures.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.launch import serve as jserve
from repro.runtime.scheduler import ContinuousBatcher as JBatcher
from repro.runtime.scheduler import SchedulerConfig as JSched
from repro_torch.launch import serve as tserve
from repro_torch.runtime.scheduler import ContinuousBatcher, SchedulerConfig
from torch_parity import twin_models

ARCHS = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "gemma2-27b", "jamba-1.5-large-398b",
         "xlstm-125m", "granite-34b", "stablelm-3b"]
LAYERS = {"gemma2-27b": 2, "xlstm-125m": 2, "jamba-1.5-large-398b": 5}


def _models(arch, n_layers=None):
    n = n_layers or LAYERS.get(arch)
    return twin_models(arch, **({"n_layers": n} if n else {}))


def _wires(cfg, seed, n_prompts=(2, 0, 3, 1), lens=(4, 20)):
    """Requests with 6 prompts in all (one request has none)."""
    rng = np.random.default_rng(seed)
    return [
        tserve.encode_request(10 + r, [
            list(map(int, rng.integers(2, cfg.vocab, rng.integers(*lens)))) for _ in range(k)
        ])
        for r, k in enumerate(n_prompts)
    ]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_requests_byte_identical(arch):
    jcfg, jparams, cfg, tparams = _models(arch)
    wires = _wires(cfg, 0)
    kw = dict(max_new=4, pad_to=16, slots=4)  # 6 sequences > 4 slots
    want = jserve.serve_requests(jparams, jcfg, wires, **kw)
    got = tserve.serve_requests(tparams, cfg, wires, device="cpu", **kw)
    assert got == want
    assert [len(o) for o in tserve.decode_response(got[2])[1]] == [4, 4, 4]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "gemma2-27b"])
def test_serve_through_the_ring(arch):
    """``pad_to`` = window: the local layers' K/V ring is full after
    prefill and decode writes wrap around it (``pos % window``)."""
    jcfg, jparams, cfg, tparams = _models(arch, n_layers=2)
    wires = _wires(cfg, 1, n_prompts=(3, 2), lens=(40, 90))
    kw = dict(max_new=3, pad_to=cfg.window, slots=3)
    want = jserve.serve_requests(jparams, jcfg, wires, **kw)
    assert tserve.serve_requests(tparams, cfg, wires, device="cpu", **kw) == want


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b", "granite-34b",
                                  "stablelm-3b"])
def test_slot_cache_follows_the_reference(arch):
    """Tick by tick the same emissions, and the whole slot cache — every
    state tensor of every slot, idle ones included — agrees with the
    reference's: it starts as zeros of prefill's shapes (mLSTM/sLSTM
    ``m`` = 0, not init_cache's -1e30) and admits copy every state."""
    jcfg, jparams, cfg, tparams = _models(arch)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(2, cfg.vocab, rng.integers(4, 12)))) for _ in range(5)]
    kw = dict(slots=3, prompt_cap=8, max_new=3, admit_cap=2)
    jb = JBatcher(jparams, jcfg, JSched(**kw))
    tb = ContinuousBatcher(tparams, cfg, SchedulerConfig(**kw))
    for i, p in enumerate(prompts):
        jb.submit(i, p)
        tb.submit(i, p)
    while jb.pending or jb.n_active:
        jb.step_begin()
        tb.step_begin()
        assert tb.step_finish() == jb.step_finish()
        for tl, jl in zip(tb.cache["layers"], jb.cache["layers"]):
            assert set(tl) == set(jl)
            for k in jl:
                np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]), rtol=1e-4,
                                           atol=1e-4)
        np.testing.assert_array_equal(tb.cache["pos"].numpy(), np.asarray(jb.cache["pos"]))
    assert tb.done == jb.done


def test_xlstm_sharded_byte_identical():
    jcfg, jparams, cfg, tparams = _models("xlstm-125m")
    wires = _wires(cfg, 2, n_prompts=(2, 2, 1, 2))
    kw = dict(max_new=4, pad_to=8, slots=4)
    base = tserve.serve_requests(tparams, cfg, wires, device="cpu", **kw)
    want = jserve.serve_requests_sharded(jparams, jcfg, wires, n_shards=3, **kw)
    fab = tserve.default_serve_fabric(3, device="cpu")
    got = tserve.serve_requests_sharded(tparams, cfg, wires, fabric=fab, device="cpu", **kw)
    assert got == want == base
    assert fab.frames_routed > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_smoke_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--n-requests", "2",
                 "--n-prompts", "2", "--max-new", "2", "--pad-to", "8", "--slots", "2"])
    assert "batched(slots=2): 2 requests, 8 tokens" in capsys.readouterr().out
