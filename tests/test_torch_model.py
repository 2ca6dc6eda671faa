"""Port parity, model: the torch ``lm`` family against the JAX package.

Parameters come from the reference ``init_params`` and are carried over by
``params_from_jax``; inputs are drawn with numpy.  Tolerance: logits agree
to ``rtol=1e-4, atol=1e-4`` in float32 — the two frameworks sum the same
products in another order (matmul blocking, softmax reductions), which
moves float32 results in their last bits, and those differences grow
through the layers.  Greedy tokens must be identical.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models import params_from_jax, prefill

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def models():
    jcfg = j_smoke_config(j_get_config("yi-6b"))
    cfg = smoke_config(get_config("yi-6b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg.dtype == "float32"
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, tparams


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_params_carried_over(models):
    jcfg, jparams, cfg, tparams = models
    np.testing.assert_array_equal(tparams.embed.numpy(), np.asarray(jparams["embed"]))
    np.testing.assert_array_equal(tparams.layers[2].ffn.wg.numpy(),
                                  np.asarray(jparams["layers"][2]["ffn"]["wg"]))
    assert sum(p.numel() for p in tparams.parameters()) == sum(
        x.size for x in jax.tree.leaves(jparams))


def test_forward_logits_allclose(models):
    jcfg, jparams, cfg, tparams = models
    toks = np.random.default_rng(0).integers(2, cfg.vocab, (2, 16)).astype(np.int32)
    jl, _, _ = j_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _, aux = forward(tparams, cfg, {"tokens": torch.from_numpy(toks)})
    assert aux == {}  # a dense model has no MoE statistics
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl)


@pytest.mark.parametrize("cache_extra", [3, 1])
def test_prefill_and_decode_allclose(models, cache_extra):
    """Prefill, then three greedy decode steps.  With ``cache_extra=1`` the
    last two steps write past the end of the cache: the reference drops
    those writes (``mode="drop"``) and so must the port."""
    jcfg, jparams, cfg, tparams = models
    S = 12
    toks = np.random.default_rng(1).integers(2, cfg.vocab, (3, S)).astype(np.int32)
    jl, jc = j_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=S + cache_extra)
    tl, tc = prefill(tparams, cfg, {"tokens": torch.from_numpy(toks)}, cache_len=S + cache_extra)
    _close(tl, jl)
    for _ in range(3):
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = j_decode_step(jparams, jcfg, jc, jtok)
        tl, tc = decode_step(tparams, cfg, tc, ttok)
        _close(tl, jl)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for tk, jk in zip(tc["layers"], jc["layers"]):
        _close(tk["k"], jk["k"])
        _close(tk["v"], jk["v"])


def test_init_params_shapes_and_seed(models):
    _, jparams, cfg, _ = models
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a.layers[1].attn.wk, b.layers[1].attn.wk)
    assert tuple(a.layers[0].attn.wq.shape) == jparams["layers"][0]["attn"]["wq"].shape
    assert float(a.layers[0].attn.wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    cache = init_cache(cfg, 2, 20, "cpu")
    assert tuple(cache["layers"][0]["k"].shape) == (2, 20, cfg.n_kv, cfg.hd)


@pytest.mark.parametrize("arch", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_multimodal_families_initialise(arch):
    """The encdec and vlm families initialise and build ``init_cache`` with
    the reference's shapes (their parity: tests/test_torch_multimodal.py)."""
    from repro.models.model import init_cache as j_init_cache

    cfg = smoke_config(get_config(arch))
    jcfg = j_smoke_config(j_get_config(arch))
    params = init_params(cfg, device="cpu")
    extra = "encoder" if cfg.family == "encdec" else "vision_proj"
    assert any(name.startswith(extra) for name, _ in params.named_parameters())
    got, want = init_cache(cfg, 2, 8, "cpu"), j_init_cache(jcfg, 2, 8)
    assert set(got) == set(want)
    assert [tuple(t.shape) for layer in got["layers"] for t in layer.values()] == [
        t.shape for layer in want["layers"] for t in layer.values()]
    assert [tuple(t.shape) for kv in got.get("enc_kv", ()) for t in kv] == [
        t.shape for kv in want.get("enc_kv", ()) for t in kv]
