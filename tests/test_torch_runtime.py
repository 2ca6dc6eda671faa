"""Port parity, the multi-device runtime on one device: the framed ring
channel (``make_framed_sender``, ``pod_ring_exchange``), the int8
cross-pod mean and its per-leaf helpers, and GPipe (``gpipe_forward``,
``split_stages``, ``stack_stage_params``), against the JAX package.

The reference runs its collectives under ``shard_map`` on the 8 fake host
devices ``tests/conftest.py`` asks for; the port carries the mesh axis as
a tensor axis.  Inputs are seeded numpy arrays.  Channels and compression
are compared bit for bit.  The reference's ``gpipe_forward`` raises on
this JAX (``ROADMAP.md`` queue C), so GPipe is held to the sequential
math: bit for bit against the same stage function applied microbatch by
microbatch, and to ``rtol=atol=1e-5`` against the reference's own jnp
oracle (float32 matmuls in another library).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP

from repro.models.model import layer_forward as j_layer_forward
from repro.runtime import channels as jch
from repro.runtime import compress as jcomp
from repro.runtime import pipeline as jpipe
from repro_torch.launch.costanalysis import analyze
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import keystr, path_parts
from repro_torch.models.model import layer_forward
from repro_torch.runtime import channels as tch
from repro_torch.runtime import compress as tcomp
from repro_torch.runtime import pipeline as tpipe
from torch_parity import twin_models


def _lanes(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t) -> np.ndarray:
    return np.asarray(t).view(np.uint32) if isinstance(t, np.ndarray) else \
        t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# framed ring channel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,words,phits", [(8, 1024, 16), (2, 2048, 32), (8, 100, 4)])
def test_framed_sender_matches_reference(n, words, phits, monkeypatch):
    """Payloads, nbytes and ok bit for bit, every member framed by one
    call of B5's join (its plain version here)."""
    rng = np.random.default_rng(n + words)
    payload = rng.integers(0, 2**32, (n, words), dtype=np.uint32)
    nbytes = rng.integers(0, 4 * words + 1, n).astype(np.int32)
    nbytes[0], nbytes[-1] = 0, 4 * words
    jmesh = jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])
    jp, jnb, jok = jax.jit(jch.make_framed_sender(jmesh, "x", frame_phits=phits))(
        jnp.asarray(payload), jnp.asarray(nbytes))
    joins = []
    real = tch.pack_frames_batch
    monkeypatch.setattr(tch, "pack_frames_batch", lambda h, d: joins.append(h.shape) or real(h, d))
    send = tch.make_framed_sender(Mesh((n,), ("x",)), "x", frame_phits=phits)
    p, nb, ok = send(_lanes(payload), torch.from_numpy(nbytes))
    assert len(joins) == 1 and joins[0][0] == n
    np.testing.assert_array_equal(_u32(p), np.asarray(jp))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.all() and list(nb.numpy()) == list(np.roll(nbytes, 1))


@pytest.mark.parametrize("shift", [1, 3])
def test_pod_ring_exchange_matches_reference(shift):
    rng = np.random.default_rng(shift)
    frames = rng.integers(0, 2**32, (8, 5, 20), dtype=np.uint32)
    jmesh = jax.make_mesh((8,), ("x",))
    ref = shard_map(lambda f: jch.pod_ring_exchange(f, "x", shift), mesh=jmesh,
                    in_specs=JP("x"), out_specs=JP("x"), check_rep=False)
    want = np.asarray(jax.jit(ref)(jnp.asarray(frames.reshape(40, 20)))).reshape(8, 5, 20)
    got = tch.pod_ring_exchange(_lanes(frames), 0, shift)
    np.testing.assert_array_equal(_u32(got), want)


def test_framed_sender_detects_corruption_and_reexports(monkeypatch):
    n = 4
    payload = np.arange(n * 64, dtype=np.uint32).reshape(n, 64)
    send = tch.make_framed_sender(Mesh((n,), ("x",)), "x", frame_phits=4)
    real = tch.pod_ring_exchange

    def corrupt(frames, axis=0, shift=1):
        frames = frames.clone()
        frames[2, 0, 7] ^= 1  # member 2's first payload word
        return real(frames, axis, shift)

    _, _, ok = send(_lanes(payload), torch.full((n,), 256))
    assert ok.all()
    monkeypatch.setattr(tch, "pod_ring_exchange", corrupt)
    _, _, ok = send(_lanes(payload), torch.full((n,), 256))
    assert ok.tolist() == [True, True, True, False]
    for name in jch.__all__:
        assert hasattr(tch, name), name
    with pytest.raises(ValueError, match="members"):
        send(_lanes(payload[:3]), torch.full((3,), 4))


def test_unframe_stream_batched_equals_one_by_one():
    from repro_torch.fabric.frames import frame_stream, unframe_stream

    rng = np.random.default_rng(3)
    payload = _lanes(rng.integers(0, 2**32, (3, 200), dtype=np.uint32))
    frames = torch.stack([frame_stream(payload[i], nb, frame_phits=8)[0]
                          for i, nb in enumerate((0, 17, 800))])
    frames[1, 0, 9] += 1
    p, nb, ok = unframe_stream(frames)
    for i in range(3):
        pi, nbi, oki = unframe_stream(frames[i])
        assert torch.equal(p[i], pi) and nb[i] == nbi and ok[i] == oki
    assert ok.tolist() == [True, False, True]


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------


def _grads(rng, lead=()):
    shapes = {"w": (4, 6), "layers.0.attn.wq": (8, 16), "b": (5,), "s": ()}
    g = {k: np.asarray(rng.standard_normal(lead + s) * 10.0 ** rng.integers(-3, 2), np.float32)
         for k, s in shapes.items()}
    e = {k: np.asarray(rng.standard_normal(v.shape) * 1e-3, np.float32) for k, v in g.items()}
    g["zero"] = np.zeros(lead + (3,), np.float32)
    e["zero"] = np.zeros(lead + (3,), np.float32)
    return g, e


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _same(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_compress_helpers_match_reference():
    g, e = _grads(np.random.default_rng(0))
    jq, js = jcomp.compress_tree(g, e)
    q, s = tcomp.compress_tree(_t(g), _t(e))
    _same(q, jq)
    _same(s, js)
    assert all(v.dtype == torch.int8 for v in q.values())
    _same(tcomp.decompress_tree(q, s), jcomp.decompress_tree(jq, js))
    _same(tcomp.new_error(_t(g), _t(e), q, s), jcomp.new_error(g, e, jq, js))
    _same(tcomp.init_error(_t(g)), jcomp.init_error(g))
    for k in g:
        qq, ss = tcomp.quantize_leaf(torch.from_numpy(g[k]), torch.from_numpy(e[k]))
        jqq, jss = jcomp.quantize_leaf(jnp.asarray(g[k]), jnp.asarray(e[k]))
        np.testing.assert_array_equal(qq.numpy(), np.asarray(jqq))
        np.testing.assert_array_equal(ss.numpy(), np.asarray(jss))
        np.testing.assert_array_equal(tcomp.dequantize_leaf(qq, ss).numpy(),
                                      np.asarray(jcomp.dequantize_leaf(jqq, jss)))


@pytest.mark.parametrize("pods", [2, 4])
def test_cross_pod_mean_int8_matches_reference(pods):
    """The pod axis as the leading tensor dim against the reference's
    ``shard_map`` over a ``pod`` mesh axis: mean and new error bit for bit;
    the mean within one quantisation step of the float32 mean and the
    residual at most one step."""
    g, e = _grads(np.random.default_rng(pods), lead=(pods,))
    jmesh = jax.make_mesh((pods, 8 // pods), ("pod", "data"))

    def red(g, e):
        m, en = jcomp.cross_pod_mean_int8(jax.tree.map(lambda x: x[0], g),
                                          jax.tree.map(lambda x: x[0], e), "pod")
        return jax.tree.map(lambda x: x[None], m), jax.tree.map(lambda x: x[None], en)

    f = shard_map(red, mesh=jmesh, in_specs=(JP("pod"), JP("pod")),
                  out_specs=(JP("pod"), JP("pod")), check_rep=False)
    jm, jen = jax.jit(f)(g, e)
    m, en = tcomp.cross_pod_mean_int8(_t(g), _t(e), "pod")
    _same(m, jm)
    _same(en, jen)
    for k in g:
        g32 = g[k] + e[k]
        step = max(np.abs(g32).max(), 1e-12) / 127
        assert np.abs(m[k].numpy() - g32.mean(0)).max() <= step * (1 + 1e-6)
        assert np.abs(en[k].numpy()).max() <= step * (1 + 1e-6)


def test_cross_pod_mean_counts_its_collectives():
    """Two all-reduces a leaf (the shared scale and the int32 sum), tagged
    for the cost analysis; the ring exchange is one collective-permute."""
    g, e = _grads(np.random.default_rng(7), lead=(2,))
    _, rep = analyze(tcomp.cross_pod_mean_int8, _t(g), _t(e))
    assert rep.collective_count == {"all-reduce": 2 * len(g)}
    want = sum(2 * 4 + 4 * v.size for v in g.values())  # 2 scales + int32 payloads
    assert rep.collective_op_bytes["all-reduce"] == want
    _, rep = analyze(tch.pod_ring_exchange, torch.zeros((8, 3, 20), dtype=torch.int32))
    assert rep.collective_op_bytes == {"collective-permute": 8 * 3 * 20 * 4}


def test_error_feedback_converges():
    g = torch.tensor([[0.3141, -0.0017], [0.9, 2e-4]])
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(64):
        q, s = tcomp.quantize_leaf(g, err)
        dq = tcomp.dequantize_leaf(q, s)
        err = g + err - dq
        acc = acc + dq
    np.testing.assert_allclose((acc / 64).numpy(), g.numpy(), rtol=2e-2, atol=2e-5)


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


def _tanh_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i])
    return x


def test_gpipe_matches_reference_math():
    """``tests/test_runtime.py``'s case: 2 stages of one layer, 4
    microbatches of (2, 6, 8)."""
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((2, 1, 8, 8)) * 0.5).astype(np.float32)
    x = rng.standard_normal((4, 2, 6, 8)).astype(np.float32)
    y = tpipe.gpipe_forward(Mesh((2,), ("pod",)), "pod", _tanh_stage,
                            {"w": torch.from_numpy(W)}, torch.from_numpy(x))
    ref = jnp.asarray(x)
    for s in range(2):
        ref = jnp.tanh(ref @ W[s, 0])
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    seq = torch.from_numpy(x)
    for s in range(2):
        seq = _tanh_stage({"w": torch.from_numpy(W[s])}, seq)
    assert torch.equal(y, seq)


def test_gpipe_schedule():
    """4 stages of 2 layers, 8 microbatches: n_micro + n_stages - 1 = 11
    ticks (one roll each), stage s takes microbatch t - s, each (stage,
    microbatch) once; bit for bit the sequential application."""
    rng = np.random.default_rng(1)
    W = torch.from_numpy((rng.standard_normal((4, 2, 8, 8)) * 0.5).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 3, 5, 8)).astype(np.float32))
    calls = []

    def stage_fn(p, a):
        calls.append(next(s for s in range(4) if torch.equal(p["w"], W[s])))
        return _tanh_stage(p, a)

    y, rep = analyze(tpipe.gpipe_forward, Mesh((4, 2), ("stage", "data")), "stage", stage_fn,
                     {"w": W}, x)
    assert rep.collective_count == {"collective-permute": 11}
    assert calls == [s for t in range(11) for s in range(4) if 0 <= t - s < 8]
    for m in range(8):
        want = x[m]
        for s in range(4):
            want = _tanh_stage({"w": W[s]}, want)
        assert torch.equal(y[m], want)


def test_split_and_stack_match_reference():
    for n, k in [(8, 4), (7, 2), (3, 3), (5, 1)]:
        assert tpipe.split_stages(list(range(n)), k) == jpipe.split_stages(list(range(n)), k)
    jcfg, jparams, cfg, params = twin_models("yi-6b", n_layers=4)
    ref = jpipe.stack_stage_params(jpipe.split_stages(jparams["layers"], 2))
    got = tpipe.stack_stage_params(tpipe.split_stages(list(params.layers), 2))
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    ref = {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}
    got = {keystr(path_parts(n)): v for n, v in got.items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


class _LayerRunner(torch.nn.Module):
    """One layer as a module, so ``functional_call`` can run it on a slice
    of the stacked stage parameters."""

    def __init__(self, layer, cfg):
        super().__init__()
        self.layer, self.cfg = layer, cfg

    def forward(self, x):
        return layer_forward(self.layer, x, self.cfg, 0, "attn", "dense", mode="full")[0]


def test_gpipe_runs_model_layers():
    """A smoke yi-6b's 4 layers in 2 stages of 2, 4 microbatches: bit for
    bit the layers applied to each microbatch in turn, and within 1e-5 of
    the reference's ``layer_forward`` on the same weights."""
    jcfg, jparams, cfg, params = twin_models("yi-6b", n_layers=4)
    runner = _LayerRunner(params.layers[0], cfg)

    def stage_fn(p, x):
        for i in range(2):
            x = torch.func.functional_call(
                runner, {f"layer.{n}": t[i] for n, t in p.items()}, (x,))
        return x

    stacked = tpipe.stack_stage_params(tpipe.split_stages(list(params.layers), 2))
    x = np.random.default_rng(2).standard_normal((4, 2, 16, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y = tpipe.gpipe_forward(Mesh((2,), ("pod",)), "pod", stage_fn, stacked,
                                torch.from_numpy(x))
        for m in range(4):
            want = torch.from_numpy(x[m])
            for lp in params.layers:
                want = layer_forward(lp, want, cfg, 0, "attn", "dense", mode="full")[0]
            assert torch.equal(y[m], want)
    ref = jnp.asarray(x.reshape(8, 16, cfg.d_model))
    for i, lp in enumerate(jparams["layers"]):
        ref = j_layer_forward(lp, ref, jcfg, i, "attn", "dense", mode="full")[0]
    np.testing.assert_allclose(y.numpy().reshape(8, 16, -1), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_runtime_exports_the_reference_names():
    import repro.runtime as jruntime
    import repro_torch.runtime as truntime

    assert truntime.__all__ == jruntime.__all__
    assert all(hasattr(truntime, n) for n in truntime.__all__)
