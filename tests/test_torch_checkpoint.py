"""Port parity, the HGum-framed checkpoint store: ``repro_torch.checkpoint``
against the JAX package's ``repro.checkpoint``.

A port checkpoint of a state must be the reference's file of the same
state, byte for byte: float32, bfloat16 (raw bits, no ``ml_dtypes``),
int8 and int32 leaves, the model's parameters and an ``OptState`` with fp32
or q8 moments under the reference's pytree paths and order.  Each store
reads the other's files.  Corruption (a flipped byte in the header, the
meta or a tensor), truncation, keep-K, the fallback to an older file and
the invisible ``.tmp`` of a crashed save are the reference's own cases.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro import optim as joptim
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import restore_into as j_restore_into
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import init_params as j_init_params
from repro_torch import optim as toptim
from repro_torch.checkpoint import (
    CheckpointManager,
    CorruptCheckpoint,
    load_checkpoint,
    restore_into,
    save_checkpoint,
)
from repro_torch.checkpoint.store import FRAME_PAYLOAD
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import opt_state_from_jax, params_from_jax


def _trees():
    """The same small state in both packages' forms: nested dicts and a
    list, bf16, float32 and int32 leaves."""
    w = np.arange(24, dtype=np.float32).reshape(4, 6) / 3
    jt = {
        "w": jnp.asarray(w, jnp.bfloat16),
        "layers": [{"a": jnp.ones((3,), jnp.float32) * i} for i in range(3)],
        "step": jnp.asarray(7, jnp.int32),
    }
    tt = {
        "w": torch.from_numpy(w).to(torch.bfloat16),
        "layers": [{"a": torch.ones(3) * i} for i in range(3)],
        "step": torch.tensor(7, dtype=torch.int32),
    }
    return jt, tt


def _model_states(moments):
    """yi-6b's smoke model and an AdamW state after one step, the
    reference's and the port's copy of it."""
    import dataclasses
    jcfg = dataclasses.replace(j_smoke_config(j_get_config("yi-6b")), n_layers=2,
                               dtype="bfloat16")
    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")), n_layers=2, dtype="bfloat16")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    g = jax.tree.map(lambda x: jnp.full(x.shape, 1e-2, jnp.float32), jp)
    ocfg = joptim.AdamWConfig(moments=moments)
    jp, jst, _ = joptim.adamw_update(g, joptim.adamw_init(jp, moments), jp, ocfg, 1e-3)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return {"params": jp, "opt": jst}, {"params": tp, "opt": opt_state_from_jax(
        jax.tree.map(np.asarray, jst), tp)}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_file_byte_identical_to_reference(tmp_path):
    jt, tt = _trees()
    j_save(str(tmp_path / "j.hgck"), jt, meta={"note": "x"})
    save_checkpoint(str(tmp_path / "t.hgck"), tt, meta={"note": "x"})
    assert _bytes(tmp_path / "t.hgck") == _bytes(tmp_path / "j.hgck")


@pytest.mark.parametrize("moments", ["fp32", "q8"])
def test_model_and_opt_state_byte_identical(tmp_path, moments):
    """{"params": model, "opt": OptState}: bf16 parameters, the float32
    master and moments (q8: int8 blocks, float32 scales, bf16 nu), the
    int32 step, under ``['opt'].mu['layers'][0]['attn']['wq']`` paths."""
    jtree, ttree = _model_states(moments)
    j_save(str(tmp_path / "j.hgck"), jtree, meta={"arch": "yi-6b", "step": 1})
    save_checkpoint(str(tmp_path / "t.hgck"), ttree, meta={"arch": "yi-6b", "step": 1})
    assert _bytes(tmp_path / "t.hgck") == _bytes(tmp_path / "j.hgck")
    meta, tensors = load_checkpoint(str(tmp_path / "t.hgck"))
    assert "['opt'].mu['layers'][0]['attn']['wq']" + ("['q']" if moments == "q8" else "") \
        in tensors
    dtypes = {t["dtype"] for t in meta["tensors"]}
    assert dtypes == ({"bfloat16", "float32", "int32", "int8"} if moments == "q8"
                      else {"bfloat16", "float32", "int32"})


def test_each_store_reads_the_others_files(tmp_path):
    jtree, ttree = _model_states("q8")
    j_save(str(tmp_path / "j.hgck"), jtree)
    save_checkpoint(str(tmp_path / "t.hgck"), ttree)
    _, from_ref = load_checkpoint(str(tmp_path / "j.hgck"))
    _, from_port = j_load(str(tmp_path / "t.hgck"))
    assert set(from_ref) == set(from_port)
    for k, a in from_ref.items():
        b = np.asarray(from_port[k])
        assert a.tobytes() == b.tobytes(), k
    # the reference restores the port's file
    back = j_restore_into(jtree, from_port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_restore_into_model_and_state(tmp_path):
    """A module's parameters are overwritten in place (bf16 from its raw
    bits), the optimizer state comes back whole, each leaf of the
    template's dtype."""
    _, ttree = _model_states("fp32")
    p = str(tmp_path / "c.hgck")
    save_checkpoint(p, ttree)
    _, fresh = _model_states("fp32")
    with torch.no_grad():
        for q in fresh["params"].parameters():
            q.zero_()
    fresh["opt"] = toptim.adamw_init(fresh["params"])
    _, tensors = load_checkpoint(p)
    out = restore_into(fresh, tensors)
    assert out["params"] is fresh["params"]
    for (n, a), b in zip(out["params"].named_parameters(), ttree["params"].parameters()):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), n
    assert isinstance(out["opt"], toptim.OptState) and int(out["opt"].step) == 1
    for name in ("mu", "nu", "master"):
        for n, t in getattr(out["opt"], name).items():
            assert torch.equal(t, getattr(ttree["opt"], name)[n]), (name, n)


def test_roundtrip_small_tree(tmp_path):
    _, tt = _trees()
    p = str(tmp_path / "c.hgck")
    save_checkpoint(p, tt, meta={"note": "x"})
    meta, tensors = load_checkpoint(p)
    assert meta["user"]["note"] == "x" and tensors["['w']"].dtype == np.dtype("<u2")
    got = restore_into(tt, tensors)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], tt["w"])
    assert all(torch.equal(a["a"], b["a"]) for a, b in zip(got["layers"], tt["layers"]))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7


def test_multi_frame_tensor(tmp_path):
    p = str(tmp_path / "big.hgck")
    big = {"x": torch.arange(FRAME_PAYLOAD // 4 * 3 + 17, dtype=torch.int32)}
    save_checkpoint(p, big)
    j_save(str(tmp_path / "j.hgck"), {"x": jnp.arange(FRAME_PAYLOAD // 4 * 3 + 17,
                                                       dtype=jnp.int32)})
    assert _bytes(p) == _bytes(tmp_path / "j.hgck")
    _, tensors = load_checkpoint(p)
    assert torch.equal(restore_into(big, tensors)["x"], big["x"])


@pytest.mark.parametrize("corrupt_at", [30, 200, -30])
def test_crc_detects_corruption(tmp_path, corrupt_at):
    p = str(tmp_path / "c.hgck")
    save_checkpoint(p, _trees()[1])
    raw = bytearray(_bytes(p))
    raw[corrupt_at] ^= 0xFF
    with open(p, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(CorruptCheckpoint):
        load_checkpoint(p)


def test_truncation_detected(tmp_path):
    p = str(tmp_path / "c.hgck")
    save_checkpoint(p, _trees()[1])
    raw = _bytes(p)
    for cut in (20, 16, 1):
        with open(p, "wb") as f:
            f.write(raw[: len(raw) - cut])
        with pytest.raises(CorruptCheckpoint):
            load_checkpoint(p)


def test_manager_keep_k_and_fallback(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    _, tt = _trees()
    t = {"params": tt, "opt": toptim.adamw_init({"w": tt["w"], "a": tt["layers"][0]["a"]})}
    for s in (10, 20, 30):
        mgr.save(s, t)
    assert mgr.all_steps() == [20, 30] and mgr.latest() == 30
    raw = bytearray(_bytes(mgr.path(30)))
    raw[60] ^= 1
    with open(mgr.path(30), "wb") as f:
        f.write(bytes(raw))
    step, restored = mgr.restore_latest(t)
    assert step == 20
    assert torch.equal(restored["params"]["w"], tt["w"])
    meta, _ = load_checkpoint(mgr.path(20))
    assert meta["user"]["step"] == 20
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(t) == (None, t)


def test_atomic_no_partial_file(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d)
    mgr.save(1, _trees()[1])
    with open(os.path.join(d, "ckpt_00000002.hgck.tmp"), "wb") as f:
        f.write(b"garbage")
    assert mgr.all_steps() == [1]
