"""Port parity, device-side SER: ``encode_leaf``/``encode_message``, B4
``pack_run`` and B8 ``stamp_headers`` against the JAX package.

On the CPU ``encode_leaf``/``encode_message`` run in torch and the kernel
wrappers take their plain versions.  Both are held here, bit for bit, to
the JAX functions on the same numpy-seeded inputs: the jnp encode, the
Pallas ``pack_run`` in interpret mode and ``kernels.ref``.  The Pallas
``stamp_headers`` does not run on this JAX (``pl.store`` is gone), so B8
is held to ``ref.stamp_headers_ref`` alone.  The CUDA kernels are held to
their plain versions on the card by ``tests/test_torch_cuda.py``.
"""
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import repro.core as jc
import repro.data.schemas as jschemas
from repro.kernels import frame_pack as jfp
from repro.kernels import ref as jref
import repro_torch.core as tc
import repro_torch.data.schemas as tschemas
from repro_torch.core import fsm as tfsm
from repro_torch.core import lanes_u32
from repro_torch.device import NoCudaError
from repro_torch.kernels import frame_pack as fp
from repro_torch.kernels import ops
import torch_parity  # noqa: F401 (process setup: a share of the cores, TF32 off)

# the schema of tests/test_kernels.py's end-to-end decode
KERNEL_TEST_SCHEMA = {
    "Msg": [["hdr", ["Bytes", 8]],
            ["a", ["List", ["Array", ["Struct", "T"]]]],
            ["tail", ["Bytes", 2]]],
    "T": [["x", ["Bytes", 4]], ["y", ["Bytes", 8]]],
}
SCHEMAS = ["request", "response", "batch", "kernel_test"]


def _schemas(name):
    """(JAX schema, port schema) of one of SCHEMAS."""
    if name == "kernel_test":
        return jc.Schema.from_json(KERNEL_TEST_SCHEMA), tc.Schema.from_json(KERNEL_TEST_SCHEMA)
    args = (8,) if name == "batch" else ()
    return (getattr(jschemas, f"{name}_schema")(*args),
            getattr(tschemas, f"{name}_schema")(*args))


def _lanes(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32).copy())


def _wire(schema_name: str, seed: int):
    js, ts = _schemas(schema_name)
    msg = jc.random_message(js, np.random.default_rng(seed), max_elems=6)
    return js, ts, jc.ser_sw_to_hw(js, msg)


# ---------------------------------------------------------------------------
# encode_leaf / encode_message against the jnp encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("schema", SCHEMAS)
def test_encode_message_matches_jax(schema, seed):
    """Random lanes (bits past each field's width set) into every path of a
    plan whose caps run 3 rows past the counts: the pad rows (offset 0) must
    be dropped, the high bytes cut."""
    js, ts, wire = _wire(schema, seed)
    counts = tc.plan_from_wire(ts, wire).counts
    caps = {p: n + 3 for p, n in counts.items()}
    jplan = jc.plan_from_wire(js, wire, caps=caps)
    tplan = tc.plan_from_wire(ts, wire, caps=caps)
    rng = np.random.default_rng(100 + seed)
    vals = {p: rng.integers(0, 2**32, (caps[p], (tplan.nbytes[p] + 3) // 4), dtype=np.uint32)
            for p in tplan.offsets}
    want = np.asarray(jc.encode_message(len(wire), jplan,
                                        {p: jnp.asarray(v) for p, v in vals.items()}))
    got = tc.encode_message(len(wire), tplan, {p: _lanes(v) for p, v in vals.items()})
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("schema", SCHEMAS)
def test_decode_encode_gives_back_the_wire(schema, seed):
    """decode -> encode is the identity on a ``ser_sw_to_hw`` wire, in the
    port and in the reference alike."""
    js, ts, wire = _wire(schema, seed)
    tplan = tc.plan_from_wire(ts, wire)
    got = tc.encode_message(len(wire), tplan,
                            tc.decode_message(tc.wire_to_u8(wire, "cpu"), tplan))
    assert bytes(got.numpy()) == wire
    jplan = jc.plan_from_wire(js, wire)
    want = jc.encode_message(len(wire), jplan, jc.decode_message(jc.wire_to_u8(wire), jplan))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kernel DES (plain versions on the CPU) decodes to the same lanes
    dec = ops.decode_message_kernel(ops.wire_to_u32(wire, "cpu"), tplan)
    assert bytes(tc.encode_message(len(wire), tplan, dec).numpy()) == wire


# offsets inside, partly past the end, wholly past it, and negative (the
# reference counts a negative index from the wire's end and drops one
# below -len)
OFFSETS = [0, 9, 30, 61, 64, 200, -3, -70]


@pytest.mark.parametrize("count", ["all", "below", "zero", "tensor"])
@pytest.mark.parametrize("nbytes", [1, 3, 4, 5, 8, 13])
def test_encode_leaf_matches_jax(nbytes, count):
    rng = np.random.default_rng(nbytes)
    wire = rng.integers(0, 256, 64, dtype=np.uint8)
    offs = np.array(OFFSETS, np.int32)
    lanes = rng.integers(0, 2**32, (len(offs), (nbytes + 3) // 4), dtype=np.uint32)
    n = {"all": len(offs), "below": 5, "zero": 0, "tensor": 6}[count]
    tcount = torch.tensor(n) if count == "tensor" else n
    want = np.asarray(jc.encode_leaf(jnp.asarray(wire), jnp.asarray(offs), jnp.asarray(lanes),
                                     nbytes, jnp.asarray(n) if count == "tensor" else n))
    src = torch.from_numpy(wire.copy())
    got = tc.encode_leaf(src, offs, _lanes(lanes), nbytes, tcount)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(src.numpy(), wire), "encode_leaf wrote into its input"


def test_encode_message_device_rules():
    """The wire is made on the values' device; with no values it is made
    on the card, and without one that raises."""
    _, ts, wire = _wire("request", 0)
    plan = tc.plan_from_wire(ts, wire)
    with pytest.raises(ValueError, match="different devices"):
        tc.encode_message(len(wire), plan, {"req_id": torch.zeros(1, 2, dtype=torch.int32),
                                            "prompts": torch.zeros(1, 1, dtype=torch.int32,
                                                                   device="meta")})
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(NoCudaError, match="device='cpu'"):
        tc.encode_message(len(wire), plan, {})


# ---------------------------------------------------------------------------
# B4 pack_run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbytes", [1, 4, 8, 13, 16])
@pytest.mark.parametrize("n", [1, 256, 517])
def test_pack_run_plain_matches_pallas_and_ref(nbytes, n):
    """The sweep of ``tests/test_kernels.py``'s ``test_pack_run_vs_oracle``."""
    rng = np.random.default_rng(nbytes * 1000 + n)
    nlanes = (nbytes + 3) // 4
    for stride in (nlanes * 4, nlanes * 4 + 4, 32):
        toks = rng.integers(0, 2**32, (n, nlanes), dtype=np.uint32)
        got = lanes_u32(ops.encode_run(_lanes(toks), stride, nbytes))
        np.testing.assert_array_equal(
            got, np.asarray(jfp.pack_run(jnp.asarray(toks), stride, nbytes, interpret=True)))
        np.testing.assert_array_equal(
            got, np.asarray(jref.pack_run_ref(jnp.asarray(toks), stride, nbytes)))


@pytest.mark.parametrize("shape,stride,nbytes,match", [
    ((4, 2), 10, 8, "4-byte aligned"),  # stride % 4 != 0
    ((4, 2), 16, 9, "do not hold"),  # nlanes != ceil(nbytes / 4)
    ((4, 3), 8, 12, "shorter than"),  # stride < 4 * nlanes
])
def test_pack_run_rejects_what_the_reference_rejects(shape, stride, nbytes, match):
    toks = np.ones(shape, np.uint32)
    with pytest.raises(ValueError, match=match):
        ops.encode_run(_lanes(toks), stride, nbytes)
    with pytest.raises(ValueError, match=match):
        fp.pack_run_plain(_lanes(toks), stride, nbytes)
    with pytest.raises((ValueError, AssertionError)):
        jfp.pack_run(jnp.asarray(toks), stride, nbytes, interpret=True)


@pytest.mark.parametrize("nbytes,stride", [(16, 16), (13, 16), (13, 20), (8, 16), (1, 4)])
def test_pack_run_then_unpack_run(nbytes, stride):
    """B4 -> B1 gives back the tokens, lane-masked to ``nbytes``."""
    nlanes = (nbytes + 3) // 4
    toks = np.random.default_rng(stride).integers(0, 2**32, (300, nlanes), dtype=np.uint32)
    wire = ops.encode_run(_lanes(toks), stride, nbytes)
    assert wire.shape == (300 * stride // 4,)
    back = lanes_u32(ops.decode_run(wire, 0, stride, 300, nbytes))
    want = np.asarray(jref.unpack_run_ref(jref.pack_run_ref(jnp.asarray(toks), stride, nbytes),
                                          0, stride, 300, nbytes))
    np.testing.assert_array_equal(back, want)
    if nbytes % 4 == 0:
        np.testing.assert_array_equal(back, toks)


# ---------------------------------------------------------------------------
# B8 stamp_headers
# ---------------------------------------------------------------------------


def _serial_stamp(wire: np.ndarray, rows) -> np.ndarray:
    """The reference's serial stamp with words outside the wire dropped."""
    out = wire.copy()
    for word, size, level in rows:
        for slot, v in ((word, size), (word + 1, level)):
            if 0 <= slot < out.shape[0]:
                out[slot] = int(v) & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("rows", [
    [[0, 100, 1], [128, 0, 2], [512, 64, 1], [1000, 4, 3]],  # tests/test_kernels.py
    [[4, 7, 1], [5, 9, 2]],  # overlapping: word 5 is the first header's level slot
    [[4, 7, 1], [4, 9, 2], [4, 11, 3]],  # repeated word: the last header wins
    [[1000, 5, 6], [2, -1, 2**31 - 1], [3, 2, 1], [1, 8, 8]],  # both neighbours, sign bits
    [],  # H = 0: a copy
], ids=["table", "overlap", "repeat", "neighbours", "empty"])
def test_stamp_headers_plain_matches_ref(rows):
    w = np.random.default_rng(4).integers(0, 2**32, 1024, dtype=np.uint32)
    hdr = np.array(rows, np.int32).reshape(-1, 3)
    got = lanes_u32(ops.write_headers(_lanes(w), torch.from_numpy(hdr)))
    np.testing.assert_array_equal(got, np.asarray(jref.stamp_headers_ref(jnp.asarray(w), hdr)))
    np.testing.assert_array_equal(got, _serial_stamp(w, rows))


def test_stamp_headers_drops_words_outside_the_wire():
    """A port rule: slots outside [0, W) are dropped (the numpy oracle
    wraps a negative word and raises past the end); each slot is judged on
    its own, so [-1, s, l] still writes l into word 0."""
    w = np.random.default_rng(5).integers(0, 2**32, 64, dtype=np.uint32)
    rows = [[63, 5, 6], [-1, 7, 8], [64, 1, 1], [-9, 2, 2], [2**31 - 1, 3, 3], [10, 4, 4]]
    got = lanes_u32(fp.stamp_headers(_lanes(w), torch.tensor(rows, dtype=torch.int32)))
    want = w.copy()
    want[63], want[0], want[10], want[11] = 5, 8, 4, 4
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _serial_stamp(w, rows))
    with pytest.raises(IndexError):
        jref.stamp_headers_ref(jnp.asarray(w), np.array([[64, 1, 1]], np.int32))


def test_stamp_headers_many_conflicts():
    """Thousands of headers over few words: the owner scatter decides every
    slot as the serial stamp does."""
    rng = np.random.default_rng(6)
    w = rng.integers(0, 2**32, 50, dtype=np.uint32)
    rows = np.stack([rng.integers(-2, 52, 3000), rng.integers(-2**31, 2**31, 3000),
                     rng.integers(-2**31, 2**31, 3000)], 1).astype(np.int32)
    got = lanes_u32(fp.stamp_headers(_lanes(w), torch.from_numpy(rows)))
    np.testing.assert_array_equal(got, _serial_stamp(w, rows))


def _framed(schema_json, msg, frame_phits):
    """A host hw2hw SER stream (the port's SerFSM) and the header table its
    framer wrote, noted by a framer that records where each header goes."""
    writers = []

    class NotingFrameWriter(tc.FrameWriter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.rows = []
            writers.append(self)

        def _note(self, size, level):
            self._align_out()
            self.rows.append((len(self.out) // 4, size, level))

        def flush(self):
            if self.buf:
                self._note(len(self.buf), self.level)
            super().flush()

        def end_list(self, level):
            self.flush()
            self._note(0, level)
            super().end_list(level)

    schema = tc.Schema.from_json(schema_json)
    toks = tc.strip_for_ser(tc.msg_to_des_tokens(schema, msg))
    with mock.patch.object(tfsm, "FrameWriter", NotingFrameWriter):
        res = tc.SerFSM(tc.build_rom(schema), "hw2hw", frame_phits=frame_phits).run(toks)
    (writer,) = writers
    assert res.frames == len(writer.rows)
    jschema = jc.Schema.from_json(schema_json)
    jres = jc.SerFSM(jc.build_rom(jschema), "hw2hw", frame_phits=frame_phits).run(
        jc.strip_for_ser(jc.msg_to_des_tokens(jschema, msg)))
    assert res.wire == jres.wire  # the port's host framer is the reference's
    return res.wire, np.array(writer.rows, np.int32).reshape(-1, 3)


@pytest.mark.parametrize("schema_json,frame_phits", [
    ({"Recs": [["hdr", ["Bytes", 3]], ["recs", ["List", ["Bytes", 13]]]]}, 500),
    ({"Recs": [["hdr", ["Bytes", 3]], ["recs", ["List", ["Bytes", 13]]]]}, 3),
    ({"M": [["a", ["List", ["Struct", "S"]]], ["t", ["Bytes", 2]]],
      "S": [["x", ["Bytes", 5]], ["ys", ["List", ["Bytes", 4]]]]}, 2),
], ids=["records-500", "records-3", "nested-2"])
def test_framed_stream_restamped(schema_json, frame_phits):
    """Zero a host framed stream's header words and stamp them back: the
    port and the reference oracle both give back the stream."""
    rng = np.random.default_rng(frame_phits)
    if "Recs" in schema_json:
        msg = {"hdr": 0xABCDEF, "recs": [int(v) for v in rng.integers(0, 2**62, 700)]}
    else:
        msg = {"a": [{"x": int(rng.integers(2**40)),
                      "ys": [int(v) for v in rng.integers(0, 2**32, int(rng.integers(0, 40)))]}
                     for _ in range(12)], "t": 7}
    stream, table = _framed(schema_json, msg, frame_phits)
    assert len(table) >= 2
    host = ops.wire_to_u32(stream, "cpu")
    zeroed = host.clone()
    words = torch.from_numpy(table[:, 0].astype(np.int64))
    zeroed[torch.cat([words, words + 1])] = 0
    assert not torch.equal(zeroed, host)
    assert torch.equal(ops.write_headers(zeroed, torch.from_numpy(table)), host)
    np.testing.assert_array_equal(
        np.asarray(jref.stamp_headers_ref(jnp.asarray(lanes_u32(zeroed)), table)),
        lanes_u32(host))


def test_ser_wrappers_reject_bad_operands():
    with pytest.raises(ValueError, match="int32 lanes"):
        ops.write_headers(torch.zeros(8, dtype=torch.int32),
                          torch.zeros(1, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(W,\) and \(H, 3\)"):
        ops.write_headers(torch.zeros(8, dtype=torch.int32),
                          torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(N, nlanes\)"):
        ops.encode_run(torch.zeros(8, dtype=torch.int32), 4, 4)
    with pytest.raises(ValueError, match="int32 lanes"):
        ops.encode_run(torch.zeros(2, 1, dtype=torch.int64), 4, 4)
