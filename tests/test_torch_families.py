"""Port parity, model families: MoE, sliding windows, gemma2 and the SSM
blocks of ``repro_torch.models`` against the JAX package.

For each ``lm`` architecture beyond the dense attention ones (mixtral,
phi3.5-moe, gemma2, jamba, xlstm) at its float32 ``smoke_config``, cut in
depth where the family allows it (gemma2 and xlstm to 2 layers, one of
each kind; jamba to 5, its first attention layer being layer 4), the
reference ``init_params`` are carried over by ``params_from_jax`` and
inputs are drawn with numpy.  Tolerance: ``rtol=atol=1e-4`` on float32
logits and ``aux``, as in ``tests/test_torch_model.py`` (the frameworks sum
the same products in another order); greedy tokens must be identical.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.configs import all_archs as j_all_archs
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import plan_period as j_plan_period
from repro.models import prefill as j_prefill
from repro.models import stack_layers as j_stack_layers
from repro.models import ffn as j_ffn
from repro.models import model as j_model
from repro_torch.configs import all_archs, get_config, smoke_config
from repro_torch.models import cache_zeros, decode_step, forward, init_params, param_count
from repro_torch.models import params_from_jax, plan_period, prefill, stack_layers
from repro_torch.models import ffn as t_ffn
from repro_torch.models import model as t_model
from torch_parity import twin_configs, twin_models

RTOL = ATOL = 1e-4
ARCHS = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "gemma2-27b", "jamba-1.5-large-398b",
         "xlstm-125m"]
LAYERS = {"gemma2-27b": 2, "xlstm-125m": 2, "jamba-1.5-large-398b": 5}
MOE_ARCHS = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b"]


def _cut(arch, changes):
    """``changes``, with the depth ``LAYERS`` gives ``arch`` unless they set one."""
    return {"n_layers": LAYERS[arch], **changes} if arch in LAYERS else changes


def _configs(arch, **changes):
    return twin_configs(arch, **_cut(arch, changes))


def _models(arch, **changes):
    return twin_models(arch, **_cut(arch, changes))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """Both packages' models of one architecture, same parameters."""
    return _models(request.param)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab, shape).astype(np.int32)


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j), rtol=RTOL, atol=ATOL)


def _close_aux(taux, jaux):
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k], jaux[k])


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


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_names_shapes_dtypes_bf16(arch):
    """At a bfloat16 config the port's parameters have the reference's
    names, shapes and dtypes: the MoE router, Mamba's A_log/D/dt_bias,
    mLSTM's wif/b_if and every sLSTM weight stay float32."""
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    spec = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(spec).items()}
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = {k: (tuple(p.shape), str(p.dtype)[len("torch."):]) for k, p in model.named_parameters()}
    assert got == want
    f32 = {k for k, (_, dt) in got.items() if dt == "float32"}
    assert bool(f32) == (arch != "gemma2-27b"), sorted(f32)
    assert all(k.split(".")[-1] in {"router", "A_log", "D", "dt_bias", "wif", "b_if"}
               or ".slstm." in k for k in f32), sorted(f32)


def test_params_carried_over(models):
    jcfg, jparams, cfg, tparams = models
    flat = _flat(jax.tree.map(np.asarray, jparams))
    for name, p in tparams.named_parameters():
        np.testing.assert_array_equal(p.numpy(), flat[name])
    assert param_count(tparams) == sum(x.size for x in jax.tree.leaves(jparams))


def test_params_from_jax_refuses_another_dtype():
    jcfg, cfg = _configs("xlstm-125m")
    # not twin_models: one leaf of the reference's tree is spoiled before the carry-over
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(0)))
    tree["layers"][1]["slstm"]["wi"] = tree["layers"][1]["slstm"]["wi"].astype(np.float16)
    with pytest.raises(ValueError, match="layers.1.slstm.wi"):
        params_from_jax(tree, cfg, "cpu")


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def test_forward_logits_and_aux(models):
    jcfg, jparams, cfg, tparams = models
    toks = _tokens(cfg, (2, 16), 0)
    jl, _, jaux = j_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tl, cache, taux = forward(tparams, cfg, {"tokens": torch.from_numpy(toks)})
    assert cache is None and tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl)
    _close_aux(taux, jaux)
    assert bool(taux) == (cfg.moe_experts > 0)


def test_prefill_then_decode(models):
    """Prefill 12 tokens, then four greedy decode steps; the caches (K/V
    and every SSM state) agree too."""
    jcfg, jparams, cfg, tparams = models
    S = 12
    toks = _tokens(cfg, (3, S), 1)
    jl, jc = j_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=S + 4)
    tl, tc = prefill(tparams, cfg, {"tokens": torch.from_numpy(toks)}, cache_len=S + 4)
    _close(tl, jl)
    for _ in range(4):
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = j_decode_step(jparams, jcfg, jc, jtok)
        tl, tc = decode_step(tparams, cfg, tc, ttok)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for tlayer, jlayer in zip(tc["layers"], jc["layers"]):
        assert set(tlayer) == set(jlayer)
        for k in jlayer:
            assert tlayer[k].dtype == getattr(torch, str(jlayer[k].dtype))
            _close(tlayer[k], jlayer[k])


def test_decode_on_cpu_takes_the_plain_attention(models):
    """CPU tensors: a decode step runs the plain append-and-attend of
    ``kernels.decode_attention`` once for each attention layer (none for
    xlstm) and the kernel's launch count stays where it was; the step's
    logits still match the reference's."""
    from unittest import mock

    from repro_torch.kernels import decode_attention as da

    jcfg, jparams, cfg, tparams = models
    toks = _tokens(cfg, (2, 6), 3)
    jl, jc = j_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=9)
    _, tc = prefill(tparams, cfg, {"tokens": torch.from_numpy(toks)}, cache_len=9)
    before = dict(da.LAUNCHES)
    with mock.patch.object(da, "append_and_attend_plain",
                           wraps=da.append_and_attend_plain) as plain:
        tl, _ = decode_step(tparams, cfg, tc, torch.from_numpy(toks[:, -1:]))
    assert plain.call_count == sum(s == "attn" for s, _ in t_model.layer_plan(cfg))
    assert da.LAUNCHES == before
    jl, _ = j_decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, -1:]))
    _close(tl, jl)


def test_prefill_on_cpu_takes_the_plain_attention(models):
    """CPU tensors: a prefill runs ``kernels.prefill_attention.attend``'s
    plain version (``flash_attention``) once for each attention layer (none
    for xlstm) and never launches the kernel; the logits still match the
    reference's."""
    from unittest import mock

    from repro_torch.kernels import prefill_attention as pa

    jcfg, jparams, cfg, tparams = models
    toks = _tokens(cfg, (2, 7), 4)
    before = dict(pa.LAUNCHES)
    with mock.patch.object(pa, "flash_attention", wraps=pa.flash_attention) as plain:
        tl, _ = prefill(tparams, cfg, {"tokens": torch.from_numpy(toks)}, cache_len=9)
    assert plain.call_count == sum(s == "attn" for s, _ in t_model.layer_plan(cfg))
    assert pa.LAUNCHES == before
    jl, _ = j_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=9)
    _close(tl, jl)


def test_scan_layers_forward(models):
    """``scan_layers=True``: the same logits, and the reference's ``aux``
    (the last period position's balance loss, averaged over periods)."""
    jcfg, jparams, cfg, tparams = models
    toks = _tokens(cfg, (2, 16), 2)
    jcfg, cfg = (dataclasses.replace(c, scan_layers=True) for c in (jcfg, cfg))
    jl, _, jaux = j_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _, taux = forward(tparams, cfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    _close_aux(taux, jaux)


def test_stack_layers(models):
    jcfg, jparams, cfg, tparams = models
    p = plan_period(cfg)
    want = {k: v.shape for k, v in _flat(j_stack_layers(jparams["layers"], p)).items()}
    got = {f"{j}.{n}": tuple(t.shape)
           for j, d in stack_layers(tparams.layers, p).items() for n, t in d.items()}
    assert got == want and p == j_plan_period(jcfg)


@pytest.mark.parametrize("arch", sorted(j_all_archs()))
def test_plan_period_every_arch(arch):
    assert sorted(all_archs()) == sorted(j_all_archs())
    assert plan_period(get_config(arch)) == j_plan_period(j_get_config(arch))
    assert plan_period(smoke_config(get_config(arch))) == j_plan_period(
        j_smoke_config(j_get_config(arch)))


def test_segment_ids_name_the_training_item(models):
    """Packed rows (the training item's segment ids: two documents and an
    EOD token of segment 0 per row, positions restarting per segment):
    logits and ``aux`` equal the reference's ``forward`` with
    ``segment_ids``; the SSM mixers ignore them, as in the reference."""
    jcfg, jparams, cfg, tparams = models
    toks = _tokens(cfg, (2, 16), 3)
    seg = np.array([[1] * 6 + [0] + [2] * 9, [1] * 11 + [0] + [2] * 4], np.int32)
    pos = np.array([list(range(6)) + [0] + list(range(9)),
                    list(range(11)) + [0] + list(range(4))], np.int32)
    batch = {"tokens": toks, "segment_ids": seg, "positions": pos}
    jl, _, jaux = j_forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, _, taux = forward(tparams, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl)
    _close_aux(taux, jaux)


def test_slot_cache_has_prefills_shapes(models):
    """``cache_zeros`` (the scheduler's slot cache) has the shapes and
    dtypes of the reference prefill's cache, batch widened, all zeros."""
    jcfg, jparams, cfg, _ = models
    spec = jax.eval_shape(lambda t: j_prefill(jparams, jcfg, {"tokens": t}, cache_len=20),
                          jax.ShapeDtypeStruct((2, 16), jnp.int32))[1]
    got = cache_zeros(cfg, 5, 16, 20, "cpu")
    want = _flat(spec)
    flat = _flat(got)
    assert set(flat) == set(want)
    for k, t in flat.items():
        assert (tuple(t.shape), str(t.dtype)[len("torch."):]) == (
            (5,) + want[k].shape[1:], str(want[k].dtype)) and not t.any()


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------


def _moe_pair(arch, **changes):
    jcfg, cfg = _configs(arch, **changes)
    jp = j_ffn.init_moe_ffn(jax.random.PRNGKey(3), jcfg, jnp.float32)
    module = t_ffn.init_moe_ffn(cfg, torch.float32, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(np.array(jp[name])))
    return jcfg, jp, cfg, module


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", ["drops", "grouped", "capacity"])
def test_moe_ffn(arch, case):
    """``drops``: capacity_factor 0.5, pairs over capacity are dropped.
    ``grouped``: 40 tokens in groups of 16 at the same factor, so the last
    group is zero-padded and its 8 pad rows tie on every expert; lax.top_k
    sends them to experts 0 and 1, where they count in the balance loss
    and overflow the capacity of 8, and so must the port's.  ``capacity``:
    an explicit capacity."""
    jcfg, jp, cfg, module = _moe_pair(arch, capacity_factor=1.25 if case == "capacity" else 0.5)
    x = np.random.default_rng(4).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    kw = {"grouped": dict(token_group=16), "capacity": dict(capacity=8)}.get(case, {})
    jy, jaux = j_ffn.moe_ffn(jp, jnp.asarray(x), jcfg, **kw)
    ty, taux = t_ffn.moe_ffn(module, torch.from_numpy(x), cfg, **kw)
    _close(ty, jy)
    _close_aux(taux, jaux)
    if case != "capacity":
        assert float(taux["moe_dropped"]) > 0


def test_moe_topk_breaks_ties_toward_lower_experts():
    """All-zero rows (uniform router probabilities) go to experts 0 and 1,
    as lax.top_k sends them."""
    jcfg, jp, cfg, module = _moe_pair("mixtral-8x22b")
    x = np.zeros((1, 8, cfg.d_model), np.float32)
    x[0, :3] = np.random.default_rng(5).standard_normal((3, cfg.d_model))
    jy, jaux = j_ffn.moe_ffn(jp, jnp.asarray(x), jcfg, capacity=8)
    ty, taux = t_ffn.moe_ffn(module, torch.from_numpy(x), cfg, capacity=8)
    _close(ty, jy)
    _close_aux(taux, jaux)
    probs = torch.softmax(torch.zeros((1, cfg.moe_experts)), -1)
    assert torch.sort(probs, descending=True, stable=True).indices[0, :2].tolist() == [0, 1]


def test_moe_capacity_matches():
    for arch in MOE_ARCHS + ["jamba-1.5-large-398b"]:
        jcfg, cfg = j_get_config(arch), get_config(arch)
        for n in (1, 16, 100, 4096, 8192):
            assert t_ffn.moe_capacity(cfg, n) == j_ffn.moe_capacity(jcfg, n)
    assert t_ffn.TOKEN_GROUP == j_ffn.TOKEN_GROUP


# ---------------------------------------------------------------------------
# sliding-window ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "gemma2-27b"])
def test_swa_ring(arch):
    """S = 2 x window: a local layer keeps the last ``window`` keys and
    decodes into the ring at ``pos % window``; a global layer (gemma2's odd
    layers) keeps all of them.  Logits, tokens and caches agree."""
    jcfg, jparams, cfg, tparams = _models(arch, n_layers=2)
    W = cfg.window
    S = 2 * W
    toks = _tokens(cfg, (2, S), 6)
    jl, jc = j_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=S + 3)
    tl, tc = prefill(tparams, cfg, {"tokens": torch.from_numpy(toks)}, cache_len=S + 3)
    assert tc["layers"][0]["k"].shape[1] == W
    assert tc["layers"][1]["k"].shape[1] == (W if cfg.attn_is_local(1) else S + 3)
    for _ in range(3):
        _close(tl, jl)
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = j_decode_step(jparams, jcfg, jc, jtok)
        tl, tc = decode_step(tparams, cfg, tc, ttok)
    _close(tl, jl)
    for tlayer, jlayer in zip(tc["layers"], jc["layers"]):
        _close(tlayer["k"], jlayer["k"])
        _close(tlayer["v"], jlayer["v"])


def test_unaligned_window_raises_as_the_reference():
    jcfg, jparams, cfg, tparams = _models("mixtral-8x22b", n_layers=1)
    S = cfg.window + cfg.window // 2
    toks = _tokens(cfg, (1, S), 7)
    with pytest.raises(ValueError, match="SWA ring alignment"):
        j_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=S + 2)
    with pytest.raises(ValueError, match="SWA ring alignment"):
        prefill(tparams, cfg, {"tokens": torch.from_numpy(toks)}, cache_len=S + 2)
    with pytest.raises(ValueError, match="SWA ring alignment"):
        cache_zeros(cfg, 2, S, S + 2, "cpu")
    # _grow_cache raises on its own, as the reference's does
    kv = [{"k": torch.zeros((1, S, cfg.n_kv, cfg.hd)), "v": torch.zeros((1, S, cfg.n_kv, cfg.hd))}]
    with pytest.raises(ValueError, match="SWA ring alignment"):
        t_model._grow_cache(cfg, kv, 1, S, S + 2, "cpu")
    jkv = [{"k": jnp.zeros((1, S, cfg.n_kv, cfg.hd)), "v": jnp.zeros((1, S, cfg.n_kv, cfg.hd))}]
    with pytest.raises(ValueError, match="SWA ring alignment"):
        j_model._grow_cache(jcfg, jkv, {"tokens": jnp.zeros((1, S))}, S, S + 2, None)
