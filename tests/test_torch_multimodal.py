"""Port parity, the vlm and encdec families: phi-3-vision's vision prefix and
whisper's encoder and cross attention in ``repro_torch.models`` against the
JAX package.

Each architecture runs at its float32 ``smoke_config`` (phi-3-vision: 16
vision tokens of width 64; whisper: 2 encoder layers over 32 frames); the
reference ``init_params`` are carried over by ``params_from_jax``, and the
inputs — tokens, and seeded non-zero ``vision`` and ``audio``, since the
serving plane's zero placeholders would hide ``vision_proj`` and the
encoder — are drawn with numpy.  Tolerance: ``rtol=atol=1e-4`` on float32
logits and cache tensors, as in ``tests/test_torch_model.py`` (the
frameworks sum the same products in another order); greedy tokens must be
identical.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.models import attention as j_attn
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import model as j_model
from repro.models import prefill as j_prefill
from repro_torch.models import cache_zeros, decode_step, forward, init_cache, init_params
from repro_torch.models import param_count, params_from_jax, prefill
from repro_torch.models import attention as t_attn
from repro_torch.models import model as t_model
from torch_parity import twin_configs, twin_models

RTOL = ATOL = 1e-4
ARCHS = ["phi-3-vision-4.2b", "whisper-tiny"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """Both packages' models of one architecture, same parameters."""
    return twin_models(request.param)


@pytest.fixture(scope="module")
def whisper():
    return twin_models("whisper-tiny")


@pytest.fixture(scope="module")
def vlm():
    return twin_models("phi-3-vision-4.2b")


def _batch(cfg, B, S, seed, modality=True):
    """numpy tokens, and the family's input drawn as a standard normal."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, cfg.vocab, (B, S)).astype(np.int32)}
    if modality and cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if modality and cfg.family == "encdec":
        batch["audio"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jit(fn, jcfg, **kw):
    """The reference entry point jitted for one config (eager JAX dispatches
    op by op, which costs more than the compile here)."""
    return jax.jit(lambda *a: fn(a[0], jcfg, *a[1:], **kw))


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j), rtol=RTOL, atol=ATOL)


def _flat(tree, prefix=""):
    """The reference pytree as {dotted name: leaf}, the port's naming."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _close_cache(tc, jc):
    """Every cache tensor: each layer's K/V, ``pos`` and ``enc_kv``."""
    assert set(tc) == set(jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for tl, jl in zip(tc["layers"], jc["layers"], strict=True):
        assert set(tl) == set(jl)
        for k in jl:
            assert tuple(tl[k].shape) == jl[k].shape
            _close(tl[k], jl[k])
    for (tk, tv), (jk, jv) in zip(tc.get("enc_kv", ()), jc.get("enc_kv", ()), strict=True):
        _close(tk, jk)
        _close(tv, jv)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_names_shapes_dtypes_bf16(arch):
    """At a bfloat16 config the port's parameters have the reference's
    names, shapes and dtypes: ``vision_proj``, ``encoder.layers.*``,
    ``encoder.final_norm`` and ``cross.*.{ln,attn}`` included."""
    jcfg, cfg = twin_configs(arch, dtype="bfloat16")
    spec = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(spec).items()}
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = {k: (tuple(p.shape), str(p.dtype)[len("torch."):]) for k, p in model.named_parameters()}
    assert got == want
    extra = {"vision_proj"} if arch == "phi-3-vision-4.2b" else {"encoder", "cross"}
    assert {k.split(".")[0] for k in got} == {"embed", "final_norm", "layers"} | extra
    assert all(dt == "bfloat16" for _, dt in got.values())


def test_params_carried_over(models):
    jcfg, jparams, cfg, tparams = models
    flat = _flat(jax.tree.map(np.asarray, jparams))
    for name, p in tparams.named_parameters():
        np.testing.assert_array_equal(p.numpy(), flat[name])
    assert len(flat) == len(dict(tparams.named_parameters()))
    assert param_count(tparams) == sum(x.size for x in jax.tree.leaves(jparams))


def test_params_from_jax_refuses_a_wrong_cross_shape():
    jcfg, cfg = twin_configs("whisper-tiny")
    # not twin_models: one leaf of the reference's tree is spoiled before the carry-over
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(0)))
    tree["cross"][1]["attn"]["wq"] = tree["cross"][1]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="cross.1.attn.wq"):
        params_from_jax(tree, cfg, "cpu")


# ---------------------------------------------------------------------------
# the sinusoid, the encoder, cross attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,d,offset", [(1, 8, 0), (7, 16, 0), (32, 128, 0), (5, 128, 37),
                                        (1, 384, 271), (1500, 384, 0)])
def test_sinusoidal(S, d, offset):
    got = t_model._sinusoidal(S, d, offset=offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, S, d)
    _close(got, j_model._sinusoidal(S, d, offset=offset))


def test_sinusoidal_per_example_offsets():
    """Decode's form: a (B,) tensor of offsets gives each example its own
    row, as the reference's ``vmap`` over ``pos`` does."""
    pos = np.array([0, 5, 17, 271], np.int32)
    got = t_model._sinusoidal(1, 64, offset=torch.from_numpy(pos))
    want = jax.vmap(lambda p: j_model._sinusoidal(1, 64, offset=p)[0])(jnp.asarray(pos))
    assert tuple(got.shape) == (4, 1, 64)
    _close(got, want)


def test_encode(whisper):
    jcfg, jparams, cfg, tparams = whisper
    audio = _batch(cfg, 2, 4, 0)["audio"]
    want = j_model.encode(jparams, jcfg, jnp.asarray(audio))
    got = t_model.encode(tparams, cfg, torch.from_numpy(audio))
    assert tuple(got.shape) == (2, cfg.enc_seq, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("S", [1, 9])
def test_cross_kv_and_cross_attn_forward(whisper, S):
    """``cross_kv`` of an encoder output, then decoder states against it:
    S = 9 (prefill) and S = 1 (decode), over T = enc_seq keys."""
    jcfg, jparams, cfg, tparams = whisper
    rng = np.random.default_rng(S)
    enc = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jp, tp = jparams["cross"][2]["attn"], tparams.cross[2].attn
    jkv = j_attn.cross_kv(jp, jnp.asarray(enc), jcfg)
    tkv = t_attn.cross_kv(tp, torch.from_numpy(enc), cfg)
    for t, j in zip(tkv, jkv):
        assert tuple(t.shape) == (2, cfg.enc_seq, cfg.n_kv, cfg.hd)
        _close(t, j)
    want = j_attn.cross_attn_forward(jp, jnp.asarray(x), jkv, jcfg)
    got = t_attn.cross_attn_forward(tp, torch.from_numpy(x), tkv, cfg)
    _close(got, want)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["vision", "no_vision", "positions"])
def test_forward_vlm(vlm, case):
    """With the vision prefix (its rows get no logits), without it, and
    with ``positions`` (the prefix takes [0, n_prefix), the text shifts)."""
    jcfg, jparams, cfg, tparams = vlm
    batch = _batch(cfg, 2, 10, 0, modality=case != "no_vision")
    if case == "positions":
        batch["positions"] = np.tile(np.arange(3, 13, dtype=np.int32), (2, 1))
    jb, tb = _both(batch)
    jl, _, _ = _jit(j_forward, jcfg)(jparams, jb)
    tl, cache, aux = forward(tparams, cfg, tb)
    assert cache is None and aux == {} and tuple(tl.shape) == (2, 10, cfg.padded_vocab)
    _close(tl, jl)


def test_forward_vision_reaches_the_logits(vlm):
    """Non-zero vision input changes the text's logits; zeros project to
    a zero prefix, which still shifts the text's positions."""
    jcfg, jparams, cfg, tparams = vlm
    batch = _batch(cfg, 1, 6, 3)
    with_vis = forward(tparams, cfg, _both(batch)[1])[0]
    batch["vision"] = np.zeros_like(batch["vision"])
    zero_vis = forward(tparams, cfg, _both(batch)[1])[0]
    assert not torch.allclose(with_vis, zero_vis)
    _close(zero_vis, _jit(j_forward, jcfg)(jparams, _both(batch)[0])[0])


def test_forward_encdec(whisper):
    jcfg, jparams, cfg, tparams = whisper
    jb, tb = _both(_batch(cfg, 2, 10, 1))
    jl, _, _ = _jit(j_forward, jcfg)(jparams, jb)
    tl, _, aux = forward(tparams, cfg, tb)
    assert aux == {}
    _close(tl, jl)
    jl, _, _ = _jit(j_forward, jcfg, last_only=True)(jparams, jb)
    tl, _, _ = forward(tparams, cfg, tb, last_only=True)
    assert tuple(tl.shape) == (2, 1, cfg.padded_vocab)
    _close(tl, jl)


def test_scan_layers_keeps_the_family_path(models):
    """``scan_layers=True`` takes the scanned route only for ``lm``: a vlm
    or encdec forward keeps its prefix and cross blocks, as in the
    reference."""
    jcfg, jparams, cfg, tparams = models
    jb, tb = _both(_batch(cfg, 2, 8, 2))
    jcfg, cfg = (dataclasses.replace(c, scan_layers=True) for c in (jcfg, cfg))
    jl, _, jaux = _jit(j_forward, jcfg)(jparams, jb)
    tl, _, taux = forward(tparams, cfg, tb)
    assert taux == {} and jaux == {}
    _close(tl, jl)


def test_prefill_then_decode(models):
    """Prefill 12 tokens (and the prefix or the audio), then four greedy
    decode steps: logits, and every cache tensor — the vlm's prefix rows,
    ``pos`` counting the prefix, ``enc_kv`` — after prefill and each step."""
    jcfg, jparams, cfg, tparams = models
    S = 12
    jb, tb = _both(_batch(cfg, 3, S, 4))
    jl, jc = _jit(j_prefill, jcfg, cache_len=S + 4)(jparams, jb)
    tl, tc = prefill(tparams, cfg, tb, cache_len=S + 4)
    _close(tl, jl)
    _close_cache(tc, jc)
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    assert tuple(tc["layers"][0]["k"].shape)[:2] == (3, S + 4 + n_prefix)
    assert int(tc["pos"][0]) == S + n_prefix
    for _ in range(4):
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = _jit(j_decode_step, jcfg)(jparams, jc, jtok)
        tl, tc = decode_step(tparams, cfg, tc, ttok)
        _close(tl, jl)
        _close_cache(tc, jc)


def test_decode_at_distinct_positions(whisper):
    """Examples at different ``pos`` take their own sinusoid rows."""
    jcfg, jparams, cfg, tparams = whisper
    jb, tb = _both(_batch(cfg, 3, 8, 5))
    jl, jc = _jit(j_prefill, jcfg, cache_len=16)(jparams, jb)
    tl, tc = prefill(tparams, cfg, tb, cache_len=16)
    pos = np.array([8, 3, 11], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc = dict(tc, pos=torch.from_numpy(pos))
    toks = np.array([[5], [7], [9]], np.int32)
    jl, jc = _jit(j_decode_step, jcfg)(jparams, jc, jnp.asarray(toks))
    tl, tc = decode_step(tparams, cfg, tc, torch.from_numpy(toks))
    _close(tl, jl)
    _close_cache(tc, jc)


def test_cache_zeros_has_prefill_shapes(models):
    """The scheduler's slot cache: zeros of the shapes and dtypes of
    prefill's cache for the scheduler's batch (tokens plus the family's
    placeholder), as the reference gets them from ``jax.eval_shape``."""
    jcfg, jparams, cfg, tparams = models
    A, S, cache_len = 3, 8, 13
    batch = _batch(cfg, A, S, 6)
    spec = jax.eval_shape(lambda p, b: j_prefill(p, jcfg, b, cache_len=cache_len)[1],
                          jparams, _both(batch)[0])
    got = cache_zeros(cfg, A, S, cache_len, "cpu")
    want = _flat(spec)
    flat = _flat(got)
    assert {k: (tuple(v.shape), str(v.dtype)[len("torch."):]) for k, v in flat.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert all(not v.any() for v in flat.values())
    _, tc = prefill(tparams, cfg, _both(batch)[1], cache_len=cache_len)
    assert {k: tuple(v.shape) for k, v in _flat(tc).items()} == {
        k: tuple(v.shape) for k, v in flat.items()}


def test_segment_ids_still_raise(vlm):
    """Packed text behind the vision prefix: segment ids (two documents and
    an EOD token of segment 0 per row) and positions restarting per
    segment; the prefix joins each row's first segment.  Logits equal the
    reference's ``forward`` with ``segment_ids`` (the name is the test's
    from before packed sequences were ported, when they raised)."""
    jcfg, jparams, cfg, tparams = vlm
    batch = _batch(cfg, 2, 12, 7)
    batch["segment_ids"] = np.array([[1] * 5 + [0] + [2] * 6, [1] * 8 + [0] + [2] * 3],
                                    np.int32)
    batch["positions"] = np.array([list(range(5)) + [0] + list(range(6)),
                                   list(range(8)) + [0] + list(range(3))], np.int32)
    jb, tb = _both(batch)
    with torch.no_grad():
        got, _, _ = forward(tparams, cfg, tb)
    want, _, _ = _jit(j_forward, jcfg)(jparams, jb)
    _close(got, want)
    unpacked, _, _ = _jit(j_forward, jcfg)(jparams, {k: v for k, v in jb.items()
                                                     if k != "segment_ids"})
    assert np.abs(np.asarray(unpacked) - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    jcfg, cfg = twin_configs(arch)
    want = _flat(j_model.init_cache(jcfg, 2, 10))
    got = _flat(init_cache(cfg, 2, 10, "cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert ("enc_kv.3.1" in got) == (arch == "whisper-tiny")
