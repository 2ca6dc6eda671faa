"""Port parity, serving the vlm and encdec families: phi-3-vision and
whisper-tiny through every serving plane of the port against the JAX
package's.

The same request wires and the same (carried-over) parameters of each
architecture's float32 ``smoke_config``, cut to 2 decoder layers (whisper
keeps its 2 encoder layers), go through both packages.  The serving plane
feeds the reference's zero ``vision``/``audio`` placeholders, so the vlm's
K/V rows hold a 16-position prefix and whisper's slots carry ``enc_kv``.
Response wires must be byte-identical: ``serve_request``, the batched plane
with more sequences than slots (eviction and slot reuse), the sharded plane
(port == reference sharded == batched) and the streaming plane (port ==
reference streamed).  Tick by tick the slot cache — K/V with the prefix
rows, ``pos``, ``enc_kv`` — agrees with the reference's to ``rtol = atol =
1e-4``.  The serve CLI takes both architectures.
"""
import dataclasses

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
from repro_torch.launch import serve as tserve
from repro_torch.models import params_from_jax
from repro_torch.runtime.scheduler import ContinuousBatcher, SchedulerConfig

ARCHS = ["phi-3-vision-4.2b", "whisper-tiny"]
KW = dict(max_new=4, pad_to=16, slots=4)


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """Both packages' models of one architecture, same parameters."""
    jcfg = dataclasses.replace(j_smoke_config(j_get_config(request.param)), n_layers=2)
    cfg = dataclasses.replace(smoke_config(get_config(request.param)), n_layers=2)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _wires(cfg, seed, n_prompts=(2, 0, 3, 1), lens=(4, 20)):
    """Requests with 6 prompts in all (one request has none)."""
    rng = np.random.default_rng(seed)
    return [
        tserve.encode_request(10 + r, [
            list(map(int, rng.integers(2, cfg.vocab, rng.integers(*lens)))) for _ in range(k)
        ])
        for r, k in enumerate(n_prompts)
    ]


def test_serve_request_byte_identical(models):
    jcfg, jparams, cfg, tparams = models
    wire = _wires(cfg, 4)[2]
    want = jserve.serve_request(jparams, jcfg, wire, max_new=3, pad_to=16)
    got = tserve.serve_request(tparams, cfg, wire, max_new=3, pad_to=16, device="cpu")
    assert got == want
    assert [len(o) for o in tserve.decode_response(got)[1]] == [3, 3, 3]


def test_serve_requests_byte_identical(models):
    """6 sequences on 4 slots: slots are reused after eviction."""
    jcfg, jparams, cfg, tparams = models
    wires = _wires(cfg, 0)
    want = jserve.serve_requests(jparams, jcfg, wires, **KW)
    got = tserve.serve_requests(tparams, cfg, wires, device="cpu", **KW)
    assert got == want
    assert [len(o) for o in tserve.decode_response(got[2])[1]] == [4, 4, 4]


def test_slot_cache_follows_the_reference(models):
    """Tick by tick the same emissions, and the whole slot cache — every
    layer's K/V (the vlm's prefix rows included), ``pos`` (which counts
    the prefix) and every ``enc_kv`` tensor, idle slots included — agrees
    with the reference's."""
    jcfg, jparams, cfg, tparams = models
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(2, cfg.vocab, rng.integers(4, 12)))) for _ in range(5)]
    kw = dict(slots=3, prompt_cap=8, max_new=3, admit_cap=2)
    jb = JBatcher(jparams, jcfg, JSched(**kw))
    tb = ContinuousBatcher(tparams, cfg, SchedulerConfig(**kw))
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    assert tuple(tb.cache["layers"][0]["k"].shape)[:2] == (3, 8 + 3 + n_prefix)
    assert set(tb._extra_inputs) == set(jb._extra_inputs)
    for i, p in enumerate(prompts):
        jb.submit(i, p)
        tb.submit(i, p)
    while jb.pending or jb.n_active:
        jb.step_begin()
        tb.step_begin()
        assert tb.step_finish() == jb.step_finish()
        assert set(tb.cache) == set(jb.cache)
        for tl, jl in zip(tb.cache["layers"], jb.cache["layers"], strict=True):
            for k in jl:
                np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]), rtol=1e-4,
                                           atol=1e-4)
        for tkv, jkv in zip(tb.cache.get("enc_kv", ()), jb.cache.get("enc_kv", ()),
                            strict=True):
            for t, j in zip(tkv, jkv, strict=True):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tb.cache["pos"].numpy(), np.asarray(jb.cache["pos"]))
    assert tb.done == jb.done


def test_sharded_byte_identical(models):
    """3 shards, ARQ on: port == reference sharded == port batched."""
    jcfg, jparams, cfg, tparams = models
    wires = _wires(cfg, 2, n_prompts=(2, 2, 1, 2))
    kw = dict(max_new=3, pad_to=8, slots=4)
    base = tserve.serve_requests(tparams, cfg, wires, device="cpu", **kw)
    want = jserve.serve_requests_sharded(jparams, jcfg, wires, n_shards=3, **kw)
    fab = tserve.default_serve_fabric(3, device="cpu")
    got = tserve.serve_requests_sharded(tparams, cfg, wires, fabric=fab, device="cpu", **kw)
    assert got == want == base
    assert fab.frames_routed > 0


def test_streaming_byte_identical(models):
    """Streamed responses, overlap and logprobs on: port == reference
    streamed == port batched, and one logprob per streamed token."""
    jcfg, jparams, cfg, tparams = models
    wires = _wires(cfg, 5, n_prompts=(2, 1, 2))
    kw = dict(max_new=3, pad_to=8, slots=4, n_shards=2)
    base = tserve.serve_requests(tparams, cfg, wires, device="cpu", max_new=3, pad_to=8,
                                 slots=4)
    want = jserve.serve_requests_streaming(jparams, jcfg, wires, **kw)
    lps = []
    got = tserve.serve_requests_streaming(tparams, cfg, wires, device="cpu", logprobs=True,
                                          on_logprob=lambda *a: lps.append(a), **kw)
    assert got == want == base
    assert len(lps) == 5 * 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plane", ["batched", "sharded", "streaming"])
def test_cli_smoke_on_cpu(arch, plane, capsys):
    extra = {"batched": [], "sharded": ["--sharded", "--n-shards", "2"],
             "streaming": ["--streaming", "--n-shards", "2", "--logprobs"]}[plane]
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--n-requests", "2",
                 "--n-prompts", "2", "--max-new", "2", "--pad-to", "8", "--slots", "2"]
                + extra)
    out = capsys.readouterr().out
    assert "2 requests, 8 tokens" in out
