"""Port parity, the training path: ``loss_fn`` and its gradients, packed
sequences in attention, remat, AdamW (fp32 and q8 moments), clipping, the
schedules, ``microbatched_grads``, ``make_train_step`` and the train CLI's
bitwise restart, against the JAX package.

Every architecture runs at its float32 ``smoke_config``, cut in depth as
``tests/test_torch_families.py`` cuts it (gemma2 and xlstm to 2 layers,
jamba to 5); the reference ``init_params`` are carried over by
``params_from_jax``.  Batches are real packed rows (``SyntheticCorpus`` with
short documents, ``pack_documents``, ``finalize_batch``: several segments
and EOD tokens of segment 0 per row), and a vlm's vision and an encdec's
audio are seeded non-zero.  Tolerances:

* loss and metrics ``rtol=1e-5``; gradient leaves ``rtol=1e-4, atol=1e-6``
  elementwise, except jamba's, held per leaf to ``1e-3 * max|g| + 1e-6``:
  its Mamba gradients are ill-conditioned in float32, so that even the
  reference's own jitted and eager runs differ beyond the elementwise
  tolerance, while float64 runs of the two packages agree closely;
* AdamW fp32 states ``rtol=1e-6, atol=1e-7`` on the same grads; q8 codes
  equal but for one step of rounding in at most 0.01 % of entries; after
  whole train steps, parameters within ``atol=5e-5`` (5 % of a step at lr
  1e-3) and moments within the grads' tolerance;
* remat on against off: equal bit for bit (the same ops, recomputed);
* ``flash_attention`` with ``p_bf16``: ``rtol=atol=2e-2`` (bf16 ``p`` and
  ``v``), float32 forms ``rtol=atol=1e-5``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro import optim as joptim
from repro.configs import all_archs as j_all_archs
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import common as jcommon
from repro.models import forward as j_forward
from repro.models import loss_fn as j_loss_fn
from repro_torch import optim as toptim
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.data import SyntheticCorpus, pack_documents
from repro_torch.data.pipeline import finalize_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import by_ref_path, forward, loss_fn, opt_state_from_jax
from repro_torch.models import params_from_jax
from repro_torch.models import common as tcommon
from torch_parity import twin_configs, twin_models

ROOT = Path(__file__).resolve().parents[1]
LAYERS = {"gemma2-27b": 2, "xlstm-125m": 2, "jamba-1.5-large-398b": 5}
B, S = 2, 24


def _cut(arch, changes):
    """``changes``, with the depth ``LAYERS`` gives ``arch`` unless they set one."""
    return {"n_layers": LAYERS[arch], **changes} if arch in LAYERS else changes


def _configs(arch, **changes):
    return twin_configs(arch, **_cut(arch, changes))


def _models(arch, **changes):
    return twin_models(arch, **_cut(arch, changes))


def _packed_batch(cfg, seed, batch=B, seq=S):
    """A packed training batch as numpy: short documents, so each row holds
    several segments and EOD tokens (segment 0); the family's input drawn
    as a standard normal."""
    tokens, segids = pack_documents(SyntheticCorpus(cfg.vocab, seed, mean_len=8).docs(),
                                    batch, seq)
    assert (segids == 0).any() and segids.max() >= 2
    out = {k: v.numpy() for k, v in finalize_batch(
        torch.from_numpy(tokens.astype(np.int32)),
        torch.from_numpy(segids.astype(np.int32))).items()}
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["audio"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _ref_paths(tree):
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t):
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: j_loss_fn(p, jcfg, b), has_aux=True))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", j_all_archs())
def test_loss_and_grads_match_reference(arch):
    jcfg, jparams, cfg, tparams = _models(arch)
    jb, tb = _both(_packed_batch(cfg, seed=3))
    (jloss, jmetrics), jgrads = _j_value_and_grad(jcfg)(jparams, jb)
    loss, grads, metrics = toptim.microbatched_grads(
        lambda p, b: loss_fn(p, cfg, b), tparams, tb, 1)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    want = _ref_paths(jgrads)
    got = by_ref_path(grads)
    assert list(got) == list(want)  # every leaf, in the reference's order
    for path, g in got.items():
        w = want[path]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        if arch == "jamba-1.5-large-398b":
            assert np.abs(_np(g) - w).max() <= 1e-3 * np.abs(w).max() + 1e-6, path
        else:
            np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-27b", "phi-3-vision-4.2b"])
def test_packed_forward_matches_reference(arch):
    """Segment-masked attention through the whole model: logits of a packed
    batch (positions restarting per segment, EOD tokens, gemma2's window,
    the vlm prefix joining the first segment) against the reference's
    ``forward`` with ``segment_ids``, and different from the unmasked
    forward's."""
    jcfg, jparams, cfg, tparams = _models(arch)
    batch = _packed_batch(cfg, seed=5, seq=32)
    jb, tb = _both(batch)
    want = np.asarray(jax.jit(lambda p, b: j_forward(p, jcfg, b)[0])(jparams, jb))
    with torch.no_grad():
        got = forward(tparams, cfg, tb)[0]
        flat = forward(tparams, cfg, {k: v for k, v in tb.items() if k != "segment_ids"})[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert np.abs(flat.numpy() - want).max() > 1e-3


FLASH_CASES = {
    "causal": dict(),
    "segments": dict(segments=True),
    "segments-window": dict(segments=True, window=5),
    "noncausal-kv_len": dict(causal=False, kv_len=29),
    "segments-softcap-offset": dict(segments=True, logit_cap=7.0, q_offset=3),
    "p_bf16": dict(segments=True, p_bf16=True),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    """``flash_attention``'s new arguments on several tiles (blocks of 8
    queries and 16 keys over 37 x 37, so both packages' last tiles are
    short or padded): segment ids (the reference pads them -1 / -2),
    ``kv_len``, and ``p_bf16``."""
    kw = dict(FLASH_CASES[case])
    rng = np.random.default_rng(len(case))
    Bq, S_, K, G, D = 2, 37, 2, 3, 16
    q = rng.standard_normal((Bq, S_, K, G, D)).astype(np.float32)
    k = rng.standard_normal((Bq, S_, K, D)).astype(np.float32)
    v = rng.standard_normal((Bq, S_, K, D)).astype(np.float32)
    if kw.pop("segments", False):
        seg = np.sort(rng.integers(0, 4, (Bq, S_)), axis=1).astype(np.int32)
        kw["segment_q"] = kw["segment_k"] = seg
    if "kv_len" in kw:
        kw["kv_len"] = np.int32(kw["kv_len"])
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) or isinstance(a, np.int32) else a
           for n, a in kw.items()}
    tkw = {n: torch.as_tensor(a) if isinstance(a, np.ndarray) or isinstance(a, np.int32)
           else a for n, a in kw.items()}
    want = jcommon.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   block_q=8, block_k=16, **jkw)
    got = tcommon.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  block_q=8, block_k=16, **tkw)
    tol = 2e-2 if kw.get("p_bf16") else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(9)
    logits = (4 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    targets = rng.integers(0, 33, (2, 7)).astype(np.int32)
    targets[0, :3] = logits[0, :3].argmax(-1)
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32)
    for m in (mask, None):
        want_loss, want = jcommon.cross_entropy(
            jnp.asarray(logits), jnp.asarray(targets), None if m is None else jnp.asarray(m),
            z_loss=1e-4)
        got_loss, got = tcommon.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m), z_loss=1e-4)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
        assert float(got["accuracy"]) > 0


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,scan", [("yi-6b", False), ("mixtral-8x22b", False),
                                       ("xlstm-125m", False), ("whisper-tiny", False),
                                       ("yi-6b", True)])
def test_remat_changes_no_value(arch, scan):
    """``remat`` on ("nothing" and "dots") against off: the same loss and
    grads, bit for bit, and the checkpointed layers really recompute."""
    _, cfg = _configs(arch, scan_layers=scan)
    batch = _both(_packed_batch(cfg, seed=7))[1]
    # the parameters drawn at the plain config, carried over at each variant of it
    tree = jax.tree.map(np.asarray, _models(arch)[1])
    outs = {}
    for remat, policy in ((False, "nothing"), (True, "nothing"), (True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        params = params_from_jax(tree, c, "cpu")
        outs[remat, policy] = toptim.microbatched_grads(
            lambda p, b: loss_fn(p, c, b), params, batch, 1)[:2]
    base_loss, base_grads = outs[False, "nothing"]
    for key, (loss, grads) in outs.items():
        assert torch.equal(loss, base_loss), key
        for n, g in grads.items():
            assert torch.equal(g, base_grads[n]), (key, n)


def test_remat_recomputes_under_autograd(monkeypatch):
    """With remat on, each layer's forward runs again in the backward
    pass; with it off, or without autograd, once."""
    from repro_torch.models import model as tmodel
    _, _, cfg, params = _models("yi-6b")
    batch = _both(_packed_batch(cfg, seed=7))[1]
    calls = []
    real = tmodel.layer_forward
    monkeypatch.setattr(tmodel, "layer_forward", lambda *a, **k: calls.append(1) or real(*a, **k))
    for remat, want in ((True, 2 * cfg.n_layers), (False, cfg.n_layers)):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat)
        toptim.microbatched_grads(lambda p, b: loss_fn(p, c, b), params, batch, 1)
        assert len(calls) == want, (remat, len(calls))
    calls.clear()
    with torch.no_grad():
        loss_fn(params, cfg, batch)
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _opt_tree(rng):
    """Reference-style params: nested dicts and lists, a bf16 leaf, a
    leaf that is not a multiple of the q8 block."""
    return {
        "w": rng.standard_normal((7, 40)).astype(np.float32),
        "layers": [{"a": rng.standard_normal(300).astype(np.float32),
                    "b": rng.standard_normal((3, 5)).astype(np.float32)} for _ in range(2)],
        "h": rng.standard_normal((16, 64)).astype(np.float32),
    }


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _named(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _named(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _run_adamw(moments, steps=6, bf16=False):
    rng = np.random.default_rng(11)
    params = _opt_tree(rng)
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3).astype(np.float32),
                          params) for _ in range(steps)]
    cfg = dict(lr=3e-2, moments=moments)
    jcfg, tcfg = joptim.AdamWConfig(**cfg), toptim.AdamWConfig(**cfg)
    to_j = (lambda x: jnp.asarray(x, jnp.bfloat16)) if bf16 else jnp.asarray
    jp = jax.tree.map(to_j, params)
    tp = {n: torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32)
          for n, a in _named(params).items()}
    jst, tst = joptim.adamw_init(jp, moments), toptim.adamw_init(tp, moments)
    lr_j = joptim.linear_warmup_cosine(3e-2, 2, steps)
    lr_t = toptim.linear_warmup_cosine(3e-2, 2, steps)
    for g in grads:
        jp, jst, jm = jax.jit(lambda p, s, g: joptim.adamw_update(g, s, p, jcfg, lr_j(s.step)))(
            jp, jst, jax.tree.map(jnp.asarray, g))
        tp, tst, tm = toptim.adamw_update({n: torch.from_numpy(a) for n, a in _named(g).items()},
                                          tst, tp, tcfg, lr_t(tst.step))
    return jp, jst, jm, tp, tst, tm


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_fp32_matches_reference(bf16):
    jp, jst, jm, tp, tst, tm = _run_adamw("fp32", bf16=bf16)
    tol = dict(rtol=1e-6, atol=1e-7)
    assert int(tst.step) == int(jst.step) == 6
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **tol, err_msg=k)
    for name, want in (("master", jst.master), ("mu", jst.mu), ("nu", jst.nu)):
        got = by_ref_path(getattr(tst, name))
        for path, w in _ref_paths(want).items():
            assert got[path].dtype == torch.float32
            np.testing.assert_allclose(got[path].numpy(), w, **tol, err_msg=f"{name}{path}")
    for path, w in _ref_paths(jp).items():
        g = by_ref_path(tp)[path]
        assert str(g.dtype)[len("torch."):] == str(w.dtype)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), **tol, err_msg=path)


def test_adamw_q8_matches_reference():
    jp, jst, jm, tp, tst, tm = _run_adamw("q8")
    jmu = _ref_paths(jst.mu)
    mu = by_ref_path(tst.mu)
    n_q = n_off = 0
    for path, enc in mu.items():
        assert enc["q"].dtype == torch.int8 and enc["s"].dtype == torch.float32
        dq = enc["q"].numpy().astype(np.int32) - jmu[path + "['q']"].astype(np.int32)
        assert np.abs(dq).max() <= 1, path
        n_q, n_off = n_q + dq.size, n_off + int((dq != 0).sum())
        np.testing.assert_allclose(enc["s"].numpy(), jmu[path + "['s']"], rtol=1e-6,
                                   err_msg=path)
    assert n_off <= 1e-4 * n_q, (n_off, n_q)
    for path, w in _ref_paths(jst.nu).items():
        got = by_ref_path(tst.nu)[path]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(w, np.float32), rtol=1e-2, err_msg=path)
    for path, w in _ref_paths(jst.master).items():
        np.testing.assert_allclose(by_ref_path(tst.master)[path].numpy(), w, rtol=1e-6,
                                   atol=1e-7, err_msg=path)


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal(40).astype(np.float32) * 3,
         "b": rng.standard_normal((9, 3)).astype(np.float32)}
    for max_norm in (1.0, 1e3):
        jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        tc, tn = toptim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                            max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(toptim.global_norm(tc)), float(joptim.global_norm(jc)),
                                   rtol=1e-6)


def test_schedules_match_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for jfn, tfn in ((joptim.linear_warmup_cosine(1e-3, 10, 110, 0.1),
                      toptim.linear_warmup_cosine(1e-3, 10, 110, 0.1)),
                     (joptim.cosine_schedule(1.0, 100), toptim.cosine_schedule(1.0, 100))):
        want = np.asarray(jax.vmap(jfn)(jnp.asarray(steps)))
        got = tfn(torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
        assert float(tfn(5)) == pytest.approx(float(jfn(jnp.asarray(5))), rel=1e-6)


def test_microbatched_grads_match_reference():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((8, 4)).astype(np.float32)
    batch = {"x": rng.standard_normal((6, 8)).astype(np.float32),
             "y": rng.standard_normal((6, 4)).astype(np.float32)}

    def jloss(p, b):
        loss = jnp.mean((b["x"] @ p["W"] - b["y"]) ** 2)
        return loss, {"loss": loss}

    def tloss(p, b):
        loss = torch.mean((b["x"] @ p["W"] - b["y"]) ** 2)
        return loss, {"loss": loss}

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for n in (1, 3):
        jl, jg, jm = joptim.microbatched_grads(jloss, {"W": jnp.asarray(W)},
                                               jax.tree.map(jnp.asarray, batch), n)
        tl, tg, tm = toptim.microbatched_grads(tloss, {"W": torch.from_numpy(W)}, tb, n)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
        np.testing.assert_allclose(tg["W"].numpy(), np.asarray(jg["W"]), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="not divisible"):
        toptim.microbatched_grads(tloss, {"W": torch.from_numpy(W)}, tb, 4)


def test_microbatched_grad_dtypes():
    """A bf16 parameter's grad is bf16 with one microbatch and float32 over
    several, as in the reference."""
    W = torch.ones((4, 2), dtype=torch.bfloat16)
    b = {"x": torch.ones((4, 4), dtype=torch.bfloat16)}

    def loss(p, b):
        out = (b["x"] @ p["W"]).float().sum()
        return out, {"loss": out}

    assert toptim.microbatched_grads(loss, {"W": W}, b, 1)[1]["W"].dtype == torch.bfloat16
    assert toptim.microbatched_grads(loss, {"W": W}, b, 2)[1]["W"].dtype == torch.float32


def test_opt_state_from_jax():
    jcfg, jparams, cfg, tparams = _models("yi-6b")
    for moments in ("fp32", "q8"):
        jst = joptim.adamw_init(jparams, moments)
        st = opt_state_from_jax(jax.tree.map(np.asarray, jst), tparams)
        want = toptim.adamw_init(tparams, moments)
        assert int(st.step) == 0 and st.step.dtype == torch.int32
        for name in ("mu", "nu", "master"):
            a, b = getattr(st, name), getattr(want, name)
            assert list(by_ref_path(a)) == list(by_ref_path(b)) == list(
                _ref_paths(jparams))
            for n in a:
                x, y = (a[n], b[n]) if name != "mu" or moments == "fp32" else (a[n]["q"], b[n]["q"])
                assert x.dtype == y.dtype and torch.equal(x, y), (name, n)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_make_train_step_matches_reference():
    """One step of the reference's jitted train step and the port's, from
    the same parameters, optimizer state and packed batch, with two
    microbatches: metrics, parameters and every optimizer leaf."""
    jcfg, jparams, cfg, tparams = _models("yi-6b", n_layers=2, microbatch=2)
    jb, tb = _both(_packed_batch(cfg, seed=13, batch=4))
    ocfg = dict(lr=1e-3)
    jst = joptim.adamw_init(jparams)
    jstep = jax.jit(j_make_train_step(jcfg, joptim.AdamWConfig(**ocfg),
                                      joptim.linear_warmup_cosine(1e-3, 1, 10)))
    tstep = make_train_step(cfg, toptim.AdamWConfig(**ocfg),
                            toptim.linear_warmup_cosine(1e-3, 1, 10))
    tst = opt_state_from_jax(jax.tree.map(np.asarray, jst), tparams)
    for _ in range(2):  # step 0 has lr 0 under the warmup
        jparams, jst, jm = jstep(jparams, jst, jb)
        tparams, tst, tm = tstep(tparams, tst, tb)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    # parameters: 5 % of a step (lr x |delta| <= 1e-3): AdamW's step is
    # normalized, so a grad element near zero (heavy cancellation) passes
    # its relative float32 noise on to its step whole; moments: the grads'
    # tolerance
    got = by_ref_path(dict(tparams.named_parameters()))
    for path, w in _ref_paths(jparams).items():
        np.testing.assert_allclose(_np(got[path]), w, rtol=1e-4, atol=5e-5, err_msg=path)
    for name, atol in (("mu", 1e-6), ("nu", 1e-7), ("master", 5e-5)):
        got = by_ref_path(getattr(tst, name))
        for path, w in _ref_paths(getattr(jst, name)).items():
            np.testing.assert_allclose(got[path].numpy(), w, rtol=1e-4, atol=atol,
                                       err_msg=f"{name}{path}")


def test_make_train_step_refuses_mesh_arguments():
    """The mesh arguments are applied as the reference applies them: the
    grads go through ``grad_shardings``, which refuse a layout that does
    not divide a grad, and the (n_micro, b / n_micro, ...) microbatches
    through ``micro_sharding_fn``; a layout that fits changes no value."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime.sharding import NamedSharding, P, param_shardings

    _, _, cfg, params = _models("yi-6b", n_layers=2, microbatch=2)
    batch = _both(_packed_batch(cfg, seed=13, batch=4))[1]
    bad = {n: NamedSharding(Mesh((3,), ("data",)), P("data"))
           for n, _ in params.named_parameters()}
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(cfg, toptim.AdamWConfig(), grad_shardings=bad)(
            params, toptim.adamw_init(params), batch)
    seen = []
    step = make_train_step(
        cfg, toptim.AdamWConfig(),
        grad_shardings=param_shardings(params, cfg, Mesh((2, 2), ("data", "model"))),
        micro_sharding_fn=lambda b: seen.append({k: tuple(v.shape) for k, v in b.items()}) or b)
    _, _, m = step(params, toptim.adamw_init(params), batch)
    _, _, cfg2, params2 = _models("yi-6b", n_layers=2, microbatch=2)
    _, _, m2 = make_train_step(cfg2, toptim.AdamWConfig())(
        params2, toptim.adamw_init(params2), batch)
    assert seen == [{k: (2, 2, S) for k in batch}]
    assert torch.equal(m["loss"], m2["loss"])
    for (n, p), p2 in zip(params.named_parameters(), params2.parameters()):
        assert torch.equal(p, p2), n


# ---------------------------------------------------------------------------
# the CLI: a bitwise restart
# ---------------------------------------------------------------------------


def _start_train(args):
    """The CLI on the host, with this process's share of the cores (which
    ``torch_parity`` hands down to subprocesses)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"] + args
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    return proc.returncode, out, err


def test_train_checkpoint_restart_bitwise(tmp_path):
    """Kill at step 12, resume, final state must equal the uninterrupted
    run (the reference's ``tests/test_launch.py`` restart, on the port)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    common = ["--arch", "xlstm-125m", "--smoke", "--steps", "16",
              "--batch", "2", "--seq", "32", "--ckpt-every", "4"]
    whole, killed = (_start_train(common + ["--ckpt-dir", d1]),
                     _start_train(common + ["--ckpt-dir", d2, "--die-at", "12"]))
    rc, out, err = _finish(whole)
    assert rc == 0 and "done" in out, err
    rc, out, err = _finish(killed)
    assert rc == 17 and "simulated failure at step 12" in out, err
    rc, out, err = _finish(_start_train(common + ["--ckpt-dir", d2, "--resume", "auto"]))
    assert rc == 0 and "resumed from step 12" in out, err
    m1, m2 = CheckpointManager(d1), CheckpointManager(d2)
    assert m1.latest() == m2.latest() == 16
    assert m1.all_steps() == m2.all_steps() == [8, 12, 16]
    meta1, t1 = load_checkpoint(m1.path(16))
    meta2, t2 = load_checkpoint(m2.path(16))
    assert meta1 == meta2 and meta1["user"]["step"] == 16
    assert set(t1) == set(t2)
    assert "['opt'].mu['layers'][0]['mlstm']['wq']" in t1
    for k in t1:
        np.testing.assert_array_equal(t1[k], t2[k], err_msg=k)


class _Flagging:
    """A ``StragglerWatchdog`` that calls the steps in ``slow`` (counted
    from the run's first step) stragglers, whatever their time."""

    def __init__(self, slow):
        self.slow, self.n, self.flagged = set(slow), 0, 0

    def start(self):
        pass

    def stop(self):
        hit = self.n in self.slow
        self.n += 1
        self.flagged += hit
        return hit


def test_straggler_checkpoints_leave_the_scheduled_ones(tmp_path, monkeypatch):
    """A straggler forces a checkpoint after its step; the next save
    supersedes it, so the kept checkpoints are the scheduled ones however
    many steps the host's load made slow.  A run that dies between a
    straggler checkpoint and the next scheduled one resumes from it, and
    ends bitwise where an uninterrupted run ends, with the same files."""
    from repro_torch.launch import train as ttrain

    def run(d, slow=(), **kw):
        monkeypatch.setattr(ttrain, "StragglerWatchdog", lambda: _Flagging(slow))
        return ttrain.train_loop("yi-6b", steps=16, batch=2, seq=32, ckpt_dir=str(d),
                                 ckpt_every=4, log_every=100, device="cpu", **kw)

    whole = run(tmp_path / "a", slow=(8, 9, 10, 13))
    assert whole["stragglers"] == 4
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [8, 12, 16]
    d = tmp_path / "b"
    with pytest.raises(SystemExit) as died:
        run(d, slow=(9,), die_at=11)
    assert died.value.code == 17
    assert CheckpointManager(str(d)).all_steps() == [4, 8, 10]
    resumed = run(d, resume="auto")
    assert resumed["steps"] == 6  # steps 10-15
    assert CheckpointManager(str(d)).all_steps() == [8, 12, 16]
    for (n, p), q in zip(whole["params"].named_parameters(), resumed["params"].parameters()):
        assert torch.equal(p, q), n
    t1 = load_checkpoint(CheckpointManager(str(tmp_path / "a")).path(16))[1]
    t2 = load_checkpoint(CheckpointManager(str(d)).path(16))[1]
    assert set(t1) == set(t2)
    for k in t1:
        np.testing.assert_array_equal(t1[k], t2[k], err_msg=k)
