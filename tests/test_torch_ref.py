"""Port parity, the kernels' oracles: ``repro_torch.kernels.ref`` (the
port's plain versions under the reference's names) against
``repro.kernels.ref`` (pure ``jnp``), bit for bit, on rows inside the wire.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
import torch_parity  # noqa: F401 (process setup: a share of the cores, TF32 off)


def _wire(n_words, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, n_words, dtype=np.uint64).astype(
        np.uint32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_wire_u32_to_u8():
    w = _wire(37, 0)
    got = tref.wire_u32_to_u8(w)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.wire_u32_to_u8(jnp.asarray(w))))
    # a tensor carrier gives the same bytes
    np.testing.assert_array_equal(tref.wire_u32_to_u8(torch.from_numpy(w.view(np.int32))),
                                  got)


@pytest.mark.parametrize("base,stride,count,nbytes", [
    (0, 4, 50, 4), (8, 12, 20, 8), (16, 64, 7, 13), (0, 8, 30, 1),  # aligned
    (3, 13, 25, 13), (1, 5, 40, 3), (6, 10, 12, 9), (2, 4, 1, 2),  # any offset
])
def test_unpack_run_ref(base, stride, count, nbytes):
    w = _wire(256, base * 100 + stride)
    want = np.asarray(jref.unpack_run_ref(jnp.asarray(w), base, stride, count, nbytes))
    got = tref.unpack_run_ref(w, base, stride, count, nbytes)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("nbytes", [1, 3, 4, 7, 8, 13, 16])
def test_unpack_gather_ref(nbytes):
    w = _wire(200, nbytes)
    offs = np.random.default_rng(nbytes).integers(0, 4 * 200 - nbytes, 33).astype(np.int32)
    want = np.asarray(jref.unpack_gather_ref(jnp.asarray(w), jnp.asarray(offs), nbytes))
    np.testing.assert_array_equal(_u32(tref.unpack_gather_ref(w, offs, nbytes)), want)


@pytest.mark.parametrize("n,stride,nbytes", [(10, 4, 4), (9, 16, 13), (5, 8, 3), (17, 24, 20),
                                             (1, 4, 1)])
def test_pack_run_ref(n, stride, nbytes):
    toks = _wire(n * ((nbytes + 3) // 4), n + nbytes).reshape(n, -1)
    want = np.asarray(jref.pack_run_ref(jnp.asarray(toks), stride, nbytes))
    got = tref.pack_run_ref(toks, stride, nbytes)
    np.testing.assert_array_equal(_u32(got), want)
    # round trip through the run oracle
    np.testing.assert_array_equal(
        _u32(tref.unpack_run_ref(got, 0, stride, n, nbytes)),
        np.asarray(jref.unpack_run_ref(jnp.asarray(want), 0, stride, n, nbytes)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stamp_headers_ref(seed):
    """In-range header slots, some repeated and some overlapping (the
    later header wins, as the serial stamp gives)."""
    rng = np.random.default_rng(seed)
    w = _wire(128, seed)
    words = rng.integers(0, 127, 40)
    words[5:9] = words[0]  # a repeated slot
    words[10] = words[11] + 1  # overlapping pairs
    hdr = np.stack([words, rng.integers(0, 1 << 32, 40, dtype=np.uint64),
                    rng.integers(0, 1 << 32, 40, dtype=np.uint64)], 1).astype(np.int64)
    want = np.asarray(jref.stamp_headers_ref(jnp.asarray(w), hdr.astype(np.uint32)))
    np.testing.assert_array_equal(_u32(tref.stamp_headers_ref(w, hdr)), want)
    np.testing.assert_array_equal(_u32(tref.stamp_headers_ref(w, torch.from_numpy(hdr))), want)
