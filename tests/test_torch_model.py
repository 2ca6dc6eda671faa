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


# ---------------------------------------------------------------------------
# attn_decode's tail: the append and the attention (kernels.decode_attention)
# ---------------------------------------------------------------------------

#: query heads a kv head -> kv heads: MHA (stablelm), mixtral's 48/8 as 6,
#: yi's GQA, granite's MQA
DECODE_GROUPS = {1: 4, 6: 2, 8: 2, 48: 1}
DECODE_T = 12
#: each row at its own position: one key, a middle one, the cache's last
#: slot, and one past the cache (dropped: the row keeps its old K/V); in a
#: ring the later ones wrap to slots 0 and 5
DECODE_POS = {"cache": [0, 5, 11, 14], "ring": [3, 11, 12, 29], "softcap": [0, 6, 11, 19]}


def _decode_configs(G: int, mode: str):
    changes = dict(n_heads=G * DECODE_GROUPS[G], n_kv=DECODE_GROUPS[G], head_dim=16)
    if mode == "ring":
        changes["window"] = DECODE_T
    if mode == "softcap":
        changes["attn_softcap"] = 50.0
    jcfg = dataclasses.replace(j_smoke_config(j_get_config("yi-6b")), **changes)
    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")), **changes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _decode_inputs(cfg, mode: str, seed: int = 0):
    """One attention layer's parameters (a softcapped mode's wq scaled up so
    its scores reach the cap), x, old caches and positions, as numpy."""
    rng = np.random.default_rng(seed)
    d, hd, nq, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
    p = {name: rng.normal(0, d ** -0.5, shape).astype(np.float32)
         for name, shape in (("wq", (d, nq * hd)), ("wk", (d, nkv * hd)),
                             ("wv", (d, nkv * hd)), ("wo", (nq * hd, d)))}
    if mode == "softcap":
        p["wq"] *= 60.0
    B = len(DECODE_POS[mode])
    x = rng.normal(size=(B, 1, d)).astype(np.float32)
    kc, vc = (rng.normal(size=(B, DECODE_T, nkv, hd)).astype(np.float32) for _ in range(2))
    return p, x, kc, vc, np.asarray(DECODE_POS[mode], np.int32)


def _decode_torch(cfg, p, x, kc, vc, pos, window):
    from repro_torch.models.attention import Attention, attn_decode

    attn = Attention(cfg, torch.float32, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, w in p.items():
            getattr(attn, name).copy_(torch.from_numpy(w))
        cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
        out, cache = attn_decode(attn, torch.from_numpy(x), cfg, cache, torch.from_numpy(pos),
                                 window=window)
    return out, cache


@pytest.mark.parametrize("mode", ["cache", "ring", "softcap"])
@pytest.mark.parametrize("G", sorted(DECODE_GROUPS))
def test_attn_decode_append_and_attend_matches_reference(G, mode):
    """The plain append-and-attend (the CPU path of ``attn_decode``) against
    the reference's ``attn_decode``: the output, both caches after the
    append, and the row past the cache unchanged on both sides."""
    from repro.models.attention import attn_decode as j_attn_decode

    jcfg, cfg = _decode_configs(G, mode)
    p, x, kc, vc, pos = _decode_inputs(cfg, mode)
    window = DECODE_T if mode == "ring" else None
    jout, jcache = j_attn_decode({k: jnp.asarray(w) for k, w in p.items()}, jnp.asarray(x), jcfg,
                                 {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, jnp.asarray(pos),
                                 window=window)
    tout, tcache = _decode_torch(cfg, p, x, kc, vc, pos, window)
    _close(tout, jout)
    for name, old in (("k", kc), ("v", vc)):
        _close(tcache[name], jcache[name])
        slots = pos % DECODE_T if window else pos
        for row, slot in enumerate(slots):
            kept = np.ones(DECODE_T, bool)
            if slot < DECODE_T:
                kept[slot] = False
            np.testing.assert_array_equal(tcache[name][row].numpy()[kept], old[row][kept])
            np.testing.assert_array_equal(np.asarray(jcache[name][row])[kept], old[row][kept])
    if mode == "softcap":  # the cap binds: the uncapped scores pass it
        q = (x[:, 0] @ p["wq"]).reshape(len(pos), -1, cfg.hd)
        assert np.abs(q @ kc[0, 0, 0] / np.sqrt(cfg.hd)).max() > jcfg.attn_softcap


@pytest.mark.parametrize("G", sorted(DECODE_GROUPS))
def test_attn_decode_on_cpu_takes_the_plain_path(G):
    """CPU tensors: ``attn_decode`` runs the plain append-and-attend once and
    the kernel's launch count stays where it was (at zero on a host with no
    card)."""
    from unittest import mock

    from repro_torch.kernels import decode_attention as da

    _, cfg = _decode_configs(G, "cache")
    before = dict(da.LAUNCHES)
    with mock.patch.object(da, "append_and_attend_plain",
                           wraps=da.append_and_attend_plain) as plain:
        out, cache = _decode_torch(cfg, *_decode_inputs(cfg, "cache"), None)
    assert plain.call_count == 1
    assert da.LAUNCHES == before
    if not torch.cuda.is_available():
        assert da.LAUNCHES == {"decode_attention": 0}
    assert tuple(out.shape) == (len(DECODE_POS["cache"]), 1, cfg.d_model)


@pytest.mark.parametrize("B,K,G,T,want", [
    (128, 4, 8, 1152, dict(gc=8, gc_max=8, n_groups=1, n_splits=1, split_len=1152)),
    (64, 8, 6, 1152, dict(gc=6, gc_max=6, n_groups=1, n_splits=1, split_len=1152)),
    (16, 1, 48, 640, dict(gc=8, gc_max=8, n_groups=6, n_splits=3, split_len=256)),
    (4, 16, 2, 4096, dict(gc=2, gc_max=2, n_groups=1, n_splits=5, split_len=832)),
    (4, 4, 1, 22, dict(gc=1, gc_max=1, n_groups=1, n_splits=1, split_len=64)),
    (2, 4, 3, 1152, dict(gc=3, gc_max=4, n_groups=1, n_splits=18, split_len=64)),
])
def test_decode_attention_plan(B, K, G, T, want):
    """The kernel's launch shape from the call's on a 132-SM card: head
    groups of at most 8 in the narrowest built width, splits while the
    blocks stay under two an SM, no split shorter than a tile a warp."""
    from repro_torch.kernels import decode_attention as da

    got = da.plan(B, K, G, T, 132)
    assert got == want
    assert got["n_splits"] * got["split_len"] >= T > (got["n_splits"] - 1) * got["split_len"]
    assert got["split_len"] % (da.TILE * da.WARPS) == 0 or got["n_splits"] == 1


@pytest.mark.parametrize("bad", ["k", "pos", "q_dtype", "head_dim", "cache_view"])
def test_decode_attention_rejects_what_the_kernel_does_not_take(bad):
    """The kernel wrapper's checks (run before any launch): a k of another
    shape, a pos of another length, q in another dtype than the caches, a
    head dim that is no multiple of 16, a cache that is a strided view."""
    from repro_torch.kernels import decode_attention as da

    B, T, K, G, D = 3, 10, 2, 4, 32
    if bad == "head_dim":
        D = 24
    x = dict(q=torch.zeros(B, 1, K, G, D, dtype=torch.bfloat16),
             k=torch.zeros(B, K, D, dtype=torch.bfloat16),
             v=torch.zeros(B, K, D, dtype=torch.bfloat16),
             k_cache=torch.zeros(B, T, K, D, dtype=torch.bfloat16),
             v_cache=torch.zeros(B, T, K, D, dtype=torch.bfloat16),
             pos=torch.zeros(B, dtype=torch.int32))
    if bad != "head_dim":
        assert da._check(**x) == (B, T, K, G, D)
    if bad == "k":
        x["k"] = x["k"][:, :1]
    elif bad == "pos":
        x["pos"] = x["pos"][:2]
    elif bad == "q_dtype":
        x["q"] = x["q"].float()
    elif bad == "cache_view":
        x["k_cache"] = torch.zeros(B, T, K, 2 * D, dtype=torch.bfloat16)[..., :D]
        x["v_cache"] = x["k_cache"]
    with pytest.raises(ValueError):
        da._check(**x)


# ---------------------------------------------------------------------------
# prefill attention (kernels.prefill_attention): on the CPU, flash_attention
# ---------------------------------------------------------------------------

#: (S, T, K, G, D, dtype, flash_attention's keywords): yi-6b's and mixtral's
#: groups, granite's MQA, a softcapped window, packed segments with an
#: offset, a kv_len, cross attention (S != T, no mask), one query, p_bf16
PREFILL_CASES = {
    "causal-yi": (33, 33, 2, 8, 32, torch.float32, {}),
    "causal-bf16-mixtral": (21, 21, 2, 6, 32, torch.bfloat16, {}),
    "mqa": (17, 17, 1, 48, 16, torch.float32, {}),
    "window-softcap": (40, 40, 2, 2, 16, torch.float32, dict(window=7, logit_cap=5.0)),
    "segments-offset": (19, 25, 2, 3, 16, torch.float32, dict(q_offset=6, segments=True)),
    "kv_len": (12, 20, 1, 4, 16, torch.float32, dict(causal=False, kv_len=9)),
    "cross": (5, 30, 3, 1, 64, torch.float32, dict(causal=False)),
    "one-query": (1, 30, 2, 2, 32, torch.bfloat16, dict(causal=False, logit_cap=50.0)),
    "p_bf16": (26, 26, 2, 2, 16, torch.float32, dict(p_bf16=True, scale=0.3)),
}


def _prefill_inputs(S, T, K, G, D, dtype, kw, B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((B, S, K, G, D), (B, T, K, D), (B, T, K, D)))
    kw = dict(kw)
    if kw.pop("segments", False):
        kw["segment_q"] = torch.sort(torch.randint(0, 3, (B, S), generator=g), dim=1).values
        kw["segment_k"] = torch.sort(torch.randint(0, 3, (B, T), generator=g), dim=1).values
    return q, k, v, kw


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_attention_on_cpu_is_flash_attention(case):
    """CPU tensors: ``attend`` is ``flash_attention`` bit for bit, with the
    same keywords, and never launches."""
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.models.common import flash_attention

    q, k, v, kw = _prefill_inputs(*PREFILL_CASES[case])
    before = dict(pa.LAUNCHES)
    got = pa.attend(q, k, v, **kw)
    assert pa.LAUNCHES == before
    want = flash_attention(q, k, v, **kw)
    assert got.dtype == q.dtype and torch.equal(got, want)


@pytest.mark.parametrize("bad", ["k_shape", "v_shape", "dtype", "mixed_dtype", "head_dim",
                                 "head_dim_wide", "segments_alone", "segment_shape",
                                 "device", "no_keys"])
def test_prefill_attention_rejects_what_the_kernel_does_not_take(bad):
    """The kernel wrapper's checks (run before any launch): k or v of
    another shape, float16 or mixed dtypes, head dims that are no multiple
    of 16 or wider than 128, one side of the segment ids, segment ids of
    another length, k on another device than q, no keys."""
    from repro_torch.kernels import prefill_attention as pa

    B, S, T, K, G, D = 2, 9, 11, 2, 3, 32
    if bad == "head_dim":
        D = 24
    elif bad == "head_dim_wide":
        D = 144
    x = dict(q=torch.zeros(B, S, K, G, D, dtype=torch.bfloat16),
             k=torch.zeros(B, T, K, D, dtype=torch.bfloat16),
             v=torch.zeros(B, T, K, D, dtype=torch.bfloat16),
             segment_q=torch.zeros(B, S, dtype=torch.int32),
             segment_k=torch.zeros(B, T, dtype=torch.int32))
    if not bad.startswith("head_dim"):
        assert pa._check(**x) == (B, S, T, K, G, D)
    if bad == "k_shape":
        x["k"] = x["k"][:, :, :1]
    elif bad == "v_shape":
        x["v"] = x["v"][:, :-1]
    elif bad == "dtype":
        x = {n: t.half() if t.is_floating_point() else t for n, t in x.items()}
    elif bad == "mixed_dtype":
        x["q"] = x["q"].float()
    elif bad == "segments_alone":
        x["segment_k"] = None
    elif bad == "segment_shape":
        x["segment_k"] = x["segment_k"][:, 1:]
    elif bad == "device":
        x["k"] = x["k"].to("meta")
    elif bad == "no_keys":
        x["k"], x["v"] = x["k"][:, :0], x["v"][:, :0]
        x["segment_k"] = x["segment_k"][:, :0]
    with pytest.raises(ValueError):
        pa._check(**x)


@pytest.mark.parametrize("kind", ["causal", "encoder", "cross"])
def test_attention_under_autograd_keeps_the_plain_path(kind):
    """CPU tensors that require grad, grad enabled: ``attend`` is
    ``flash_attention`` under autograd too (dispatch goes by device alone),
    so ``attn_forward`` and ``cross_attn_forward`` return the plain path's
    output and gradient."""
    from unittest import mock

    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.models import attention

    cfg = smoke_config(get_config("yi-6b"))
    p = attention.Attention(cfg, torch.float32, torch.Generator().manual_seed(1))
    for w in p.parameters():
        w.requires_grad_(True)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 10, cfg.d_model), generator=g)
    enc = torch.randn((2, 14, cfg.d_model), generator=g)

    def run(attend):
        with mock.patch.object(attention, "attend", attend):
            if kind == "cross":
                out = attention.cross_attn_forward(p, x, attention.cross_kv(p, enc, cfg), cfg)
            else:
                out, _ = attention.attn_forward(p, x, cfg, causal=kind == "causal")
        grads = torch.autograd.grad(out.square().sum(), list(p.parameters()))
        return out, grads

    before = dict(pa.LAUNCHES)
    with mock.patch.object(pa, "flash_attention", wraps=pa.flash_attention) as plain:
        out, grads = run(pa.attend)
    assert plain.call_count == 1 and pa.LAUNCHES == before
    want, want_grads = run(pa.flash_attention)
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


@pytest.mark.parametrize("case", ["causal-yi", "segments-offset", "cross", "p_bf16"])
@pytest.mark.parametrize("wrt", ["qkv", "q"])
def test_prefill_attention_kernel_op_backward_is_the_plain_gradient(case, wrt):
    """The kernel's autograd op (what ``attend`` runs on the card) with its
    launch stood in for by the plain version, as the card's numbers stand
    for it: its output is the launch's, and its backward recomputes the
    plain version from the saved q, k and v and gives that version's
    gradient, bit for bit, for each input that requires grad (None for the
    rest)."""
    from unittest import mock

    from repro_torch.kernels import prefill_attention as pa

    q, k, v, kw = _prefill_inputs(*PREFILL_CASES[case], seed=4)
    full = dict(causal=True, window=None, logit_cap=None, q_offset=0, segment_q=None,
                segment_k=None, kv_len=None, scale=None, p_bf16=False)
    full.update(kw)
    xs = [t.requires_grad_(n in wrt) for t, n in zip((q, k, v), "qkv")]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(q.dtype)

    def launch(q, k, v, **kw):
        assert not torch.is_grad_enabled()  # an autograd op's forward records nothing
        return pa.flash_attention(q, k, v, **kw)

    with mock.patch.object(pa, "_launch", side_effect=launch) as kernel:
        out = pa._Kernel.apply(*xs, full)
        got = torch.autograd.grad(out, [x for x in xs if x.requires_grad], g)
    assert kernel.call_count == 1
    want_out = pa.flash_attention(*xs, **full)
    want = torch.autograd.grad(want_out, [x for x in xs if x.requires_grad], g)
    assert torch.equal(out, want_out.detach())
    assert len(got) == len(wrt) and all(torch.equal(a, b) for a, b in zip(got, want))
