"""Port parity, DES kernels: ``repro_torch.kernels`` against the JAX package.

On the CPU the wrappers take their plain versions, which are held here to
the JAX oracles (``repro.kernels.ref``, ``core.vectorized.decode_batch``)
and, for the aligned run, to the Pallas ``unpack_run`` in interpret mode.
Every public function of the reference's ``kernels.phit_unpack``,
``frame_pack`` and ``ops`` keeps its signature in the port, and a call in
the reference's keywords (``wire_u32=``, ``interpret=``, ``block=``)
gives what the call without them gives.
Rows are compared where they lie inside the wire: past it the reference
oracle clips to the last byte while the kernels (and the padded Pallas
wire) read zeros.  The CUDA kernels themselves are held to their plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import inspect
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import batch_plans as j_batch_plans
from repro.core import decode_batch as j_decode_batch
from repro.core import decode_message as j_decode_message
from repro.core import ser_sw_to_hw as j_ser
from repro.core import stack_wires as j_stack_wires
from repro.core import wire_to_u8 as j_wire_to_u8
from repro.core.idl import Schema as JSchema
from repro.data.schemas import request_schema as j_request_schema
from repro.kernels import frame_pack as j_fpack
from repro.kernels import ops as j_ops
from repro.kernels import phit_unpack as j_phit
from repro.kernels import ref as j_ref
from repro.core import plan_from_wire as j_plan_from_wire
from repro_torch.core import Schema, batch_plans, decode_batch, lanes_u32, plan_from_wire
from repro_torch.core import stack_wires
from repro_torch.data.schemas import request_schema
from repro_torch.kernels import frame_pack as fp
from repro_torch.kernels import ops, phit_unpack as pu

NBYTES = [1, 3, 4, 5, 8, 13, 16]
WIRE_BYTES = 4 * 1600
COUNT = 300  # rows per run: not a multiple of the reference's 256-row block


@pytest.fixture
def wire_np():
    return np.random.default_rng(11).integers(0, 2**32, WIRE_BYTES // 4, dtype=np.uint32)


def _t(wire_np):
    return torch.from_numpy(wire_np.view(np.int32).copy())


# (base, stride) per nbytes: aligned, unaligned base, unaligned stride
def _layouts(nbytes):
    w4 = 4 * ((nbytes + 3) // 4)
    return {"aligned": (8, w4), "base1": (1, w4), "stride": (4, nbytes + 1 + (nbytes % 4 == 3))}


@pytest.mark.parametrize("nbytes", NBYTES)
@pytest.mark.parametrize("layout", ["aligned", "base1", "stride"])
def test_plain_run_matches_ref(wire_np, nbytes, layout):
    base, stride = _layouts(nbytes)[layout]
    count = COUNT
    assert base + (count - 1) * stride + nbytes <= WIRE_BYTES  # rows inside the wire
    want = np.asarray(j_ref.unpack_run_ref(jnp.asarray(wire_np), base, stride, count, nbytes))
    got = pu.unpack_run(_t(wire_np), base, stride, count, nbytes)
    np.testing.assert_array_equal(lanes_u32(got), want)
    # the general body agrees with the aligned one wherever both apply
    np.testing.assert_array_equal(
        lanes_u32(pu.unpack_run_general(_t(wire_np), base, stride, count, nbytes)), want)
    if layout == "aligned":
        np.testing.assert_array_equal(
            lanes_u32(pu.unpack_run_aligned(_t(wire_np), base, stride, count, nbytes)), want)


@pytest.mark.parametrize("nbytes", NBYTES)
def test_plain_gather_matches_ref(wire_np, nbytes):
    rng = np.random.default_rng(nbytes)
    offs = rng.integers(0, WIRE_BYTES - nbytes + 1, COUNT)  # every phase 0..3
    want = np.asarray(j_ref.unpack_gather_ref(jnp.asarray(wire_np),
                                              jnp.asarray(offs, jnp.int32), nbytes))
    got = pu.unpack_gather(_t(wire_np), torch.from_numpy(offs), nbytes)
    np.testing.assert_array_equal(lanes_u32(got), want)


@pytest.mark.parametrize("nbytes", [1, 4, 5, 13, 16])
def test_plain_aligned_matches_pallas_interpret(wire_np, nbytes):
    """The Pallas aligned body still runs on this JAX (interpret mode)."""
    base, stride = _layouts(nbytes)["aligned"]
    count = COUNT
    want = np.asarray(j_phit.unpack_run(jnp.asarray(wire_np), base, stride, count, nbytes,
                                        interpret=True))
    got = pu.unpack_run_aligned(_t(wire_np), base, stride, count, nbytes)
    np.testing.assert_array_equal(lanes_u32(got), want)


@pytest.mark.parametrize("nlanes", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("base_w", [0, 1, 2, 3, 6])
def test_plain_dense_run_matches_ref_and_pallas(wire_np, nlanes, base_w):
    """Dense aligned runs (rows abut: stride == 4 * nlanes), the shape the
    card copies in 16-byte vectors: a start word not a multiple of 4, row
    counts whose words end mid-vector, the last lane masked."""
    nbytes = 4 * nlanes - (nlanes > 1)  # a partial last lane when nlanes > 1
    stride = 4 * nlanes
    for count in (1, 7, 299):  # 7 rows of 3 lanes leave a 1-word tail
        want = np.asarray(j_ref.unpack_run_ref(jnp.asarray(wire_np), 4 * base_w, stride,
                                               count, nbytes))
        got = pu.unpack_run_aligned(_t(wire_np), 4 * base_w, stride, count, nbytes)
        np.testing.assert_array_equal(lanes_u32(got), want)
    want = np.asarray(j_phit.unpack_run(jnp.asarray(wire_np), 4 * base_w, stride, 299,
                                        nbytes, interpret=True))
    np.testing.assert_array_equal(lanes_u32(got), want)


@pytest.mark.parametrize("nlanes", [1, 3, 4])
def test_plain_dense_run_reads_zeros_past_the_wire(wire_np, nlanes):
    """A dense run that runs off the end of the wire reads zeros there, as
    the reference does on its zero-padded wire."""
    words = 37  # not a multiple of 4
    base_w, count = 30, 5  # rows 3.. of 3 lanes lie past word 37
    padded = np.concatenate([wire_np[:words], np.zeros(64, np.uint32)])
    want = np.asarray(j_ref.unpack_run_ref(jnp.asarray(padded), 4 * base_w, 4 * nlanes,
                                           count, 4 * nlanes))
    got = pu.unpack_run_aligned(_t(wire_np[:words]), 4 * base_w, 4 * nlanes, count,
                                4 * nlanes)
    np.testing.assert_array_equal(lanes_u32(got), want)
    assert (lanes_u32(got).reshape(-1)[words - base_w:] == 0).all()


def test_plain_reads_zeros_past_the_wire(wire_np):
    """Past the wire the port reads zeros, as the padded Pallas wire does."""
    w = _t(wire_np[:3])  # 12 bytes
    got = lanes_u32(pu.unpack_run_general(w, 9, 5, 3, 5))
    b = wire_np[:3].view(np.uint8).tobytes() + bytes(32)
    want = [np.frombuffer(b[o:o + 5] + bytes(3), np.uint32) for o in (9, 14, 19)]
    np.testing.assert_array_equal(got, np.stack(want))


def _random_request_wires(rng, n=6):
    """Ragged batch: includes a zero-prompt request and an empty token list."""
    n_prompts = [0, 1, 3, 5, 2, 4]
    wires = []
    for m in range(n):
        msg = {"req_id": 100 + m, "prompts": [
            {"tokens": list(map(int, rng.integers(0, 2**31, rng.integers(0, 9))))}
            for _ in range(n_prompts[m % len(n_prompts)])
        ]}
        wires.append(j_ser(j_request_schema(), msg))
    return wires


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_batch_kernel_matches_jax_decode_batch(seed):
    rng = np.random.default_rng(seed)
    wires = _random_request_wires(rng)
    bp = j_batch_plans(j_request_schema(), wires)
    oracle = j_decode_batch(jnp.asarray(j_stack_wires(wires)), bp)
    u32, row_bytes = ops.wires_to_u32(wires, "cpu")
    got = ops.decode_batch_kernel(u32, row_bytes, bp)
    for p in oracle:
        for i in range(len(wires)):
            n = int(bp.counts[p][i])
            np.testing.assert_array_equal(lanes_u32(got[p][i, :n]),
                                          np.asarray(oracle[p][i, :n]), err_msg=p)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_batch_kernel_matches_torch_decode_batch(seed):
    """The port's own torch gather ``decode_batch`` is the oracle of its
    kernel twin, on every row that lies inside its wire."""
    wires = _random_request_wires(np.random.default_rng(seed))
    bp = batch_plans(request_schema(), wires)
    want = decode_batch(torch.from_numpy(stack_wires(wires)), bp)
    got = ops.decode_batch_kernel(*ops.wires_to_u32(wires, "cpu"), bp)
    assert got.keys() == want.keys()
    for p in want:
        for i in range(len(wires)):
            n = int(bp.counts[p][i])
            assert torch.equal(got[p][i, :n], want[p][i, :n]), p


RECORD_SCHEMA = {"Recs": [["hdr", ["Bytes", 3]], ["recs", ["Array", ["Bytes", 13]]]]}


def test_decode_message_kernel_unaligned_run_matches_jax():
    """An unaligned uniform run (13-byte records after a 3-byte header)
    takes the general run kernel; the result equals the jnp decode."""
    rng = np.random.default_rng(2)
    msg = {"hdr": 0xABCDEF, "recs": [int(v) for v in rng.integers(0, 2**62, 40)]}
    js = JSchema.from_json(RECORD_SCHEMA)
    wire = j_ser(js, msg)
    plan = plan_from_wire(Schema.from_json(RECORD_SCHEMA), wire)
    assert ops.runs_from_plan(plan, "recs.elem") == (7, 13)
    want = j_decode_message(j_wire_to_u8(wire), j_plan_from_wire(js, wire))
    got = ops.decode_message_kernel(ops.wire_to_u32(wire, "cpu"), plan)
    for p in want:
        n = plan.counts[p]
        np.testing.assert_array_equal(lanes_u32(got[p][:n]), np.asarray(want[p][:n]))


def test_wires_to_u32_rows():
    wires = [b"\x01\x02\x03", b"\x04\x05\x06\x07\x08"]
    lanes, row_bytes = ops.wires_to_u32(wires, "cpu")
    assert row_bytes == 8 and lanes.dtype == torch.int32
    assert lanes_u32(lanes).view(np.uint8).tobytes() == (
        b"\x01\x02\x03" + bytes(5) + b"\x04\x05\x06\x07\x08" + bytes(3))


# ---------------------------------------------------------------------------
# no hidden fallback
# ---------------------------------------------------------------------------


def test_recording_collects_launches(monkeypatch):
    """Inside ``recording`` every launch is kept as (kernel, wire, args),
    and counted once; outside it launches are counted only."""
    lib = mock.MagicMock()
    lib.hgum_unpack_gather.return_value = 0
    monkeypatch.setattr(pu, "_library", lambda: lib)
    monkeypatch.setattr(pu, "LAUNCHES", dict.fromkeys(pu.LAUNCHES, 0))
    with pu.recording() as calls:
        pu._launch("unpack_gather", ("wire", ("offsets", 4)), "hgum_unpack_gather", 1, 2)
    pu._launch("unpack_gather", ("wire2", ("offsets2", 4)), "hgum_unpack_gather", 3, 4)
    assert calls == [("unpack_gather", "wire", ("offsets", 4))]
    assert pu.LAUNCHES["unpack_gather"] == 2 and pu._RECORDED is None
    lib.hgum_unpack_gather.assert_any_call(1, 2)


def _forbid_plain(monkeypatch):
    calls = []
    for name in ("unpack_run_aligned_plain", "unpack_run_general_plain", "unpack_gather_plain"):
        monkeypatch.setattr(pu, name, lambda *a, _n=name, **k: calls.append(_n))
    return calls


@pytest.mark.parametrize("kernel", ["aligned", "general", "gather"])
def test_non_cpu_tensor_never_takes_plain(monkeypatch, kernel):
    """A CUDA tensor launches the kernel or raises: the wrapper must not
    route it to the plain version.  Here a mocked CUDA tensor reaches the
    launch (which cannot allocate on a host without a card) and a meta
    tensor is refused."""
    calls = _forbid_plain(monkeypatch)
    launched = []
    monkeypatch.setattr(pu, "_launch", lambda kernel, *a: launched.append(kernel))
    fake = mock.MagicMock(spec=torch.Tensor)
    fake.dtype, fake.device, fake.shape = torch.int32, torch.device("cuda", 0), (64,)
    fake.dim.return_value, fake.is_contiguous.return_value = 1, True
    offs = mock.MagicMock(spec=torch.Tensor)
    offs.dtype, offs.device, offs.shape = torch.int64, torch.device("cuda", 0), (4,)
    offs.dim.return_value, offs.is_contiguous.return_value = 1, True
    meta = torch.empty(64, dtype=torch.int32, device="meta")
    call = {
        "aligned": lambda w: pu.unpack_run_aligned(w, 0, 8, 4, 8),
        "general": lambda w: pu.unpack_run_general(w, 1, 13, 4, 13),
        "gather": lambda w: pu.unpack_gather(w, offs if w is fake else meta.long()[:4], 4),
    }[kernel]
    with pytest.raises((RuntimeError, AssertionError)):  # no CUDA in this torch
        call(fake)
    with pytest.raises(ValueError, match="unsupported device"):
        call(meta)
    assert calls == [] and launched == []


# ---------------------------------------------------------------------------
# the reference's wrapper signatures (interpret and block accepted, ignored)
# ---------------------------------------------------------------------------

_MODULES = {"phit_unpack": (j_phit, pu), "frame_pack": (j_fpack, fp), "ops": (j_ops, ops)}
# every public function each reference module defines (jitted ones included)
_REF_FUNCTIONS = sorted(
    (mod, name) for mod, (ref, _) in _MODULES.items() for name, f in vars(ref).items()
    if not name.startswith("_") and callable(f) and getattr(f, "__module__", "") == ref.__name__
)


def _kind_position(params, name):
    """Index of ``name`` among the parameters of its kind: positional ones
    by their place in the list, keyword-only ones among keyword-only."""
    kind = params[name].kind
    if kind is inspect.Parameter.KEYWORD_ONLY:
        return [n for n, p in params.items() if p.kind is kind].index(name)
    return list(params).index(name)


def test_reference_functions_found():
    assert len(_REF_FUNCTIONS) == 20
    assert ("ops", "encode_frames_batch") in _REF_FUNCTIONS


@pytest.mark.parametrize("module,name", _REF_FUNCTIONS, ids=lambda x: x)
def test_wrapper_signature_matches_reference(module, name):
    """Every parameter of the reference function is in the port's, with the
    same name, kind, position and default (the port's own additions,
    ``elem_words`` and ``device``, come after the reference's positional
    ones)."""
    ref, port = (inspect.signature(getattr(m, name)).parameters for m in _MODULES[module])
    for pname, p in ref.items():
        assert pname in port, f"{module}.{name} lacks {pname}"
        q = port[pname]
        assert q.kind is p.kind and q.default == p.default, (pname, q, p)
        assert _kind_position(port, pname) == _kind_position(ref, pname), pname


def _keyword_calls():
    """(plain call, the same call in the reference's keywords) per wrapper."""
    rng = np.random.default_rng(3)
    wire = _t(rng.integers(0, 2**32, 64, dtype=np.uint32))
    offs = torch.tensor([0, 5, 9, 100])
    toks = torch.from_numpy(rng.integers(-2**31, 2**31, (5, 3)).astype(np.int32))
    hdrs = torch.tensor([[2, 9, 1], [2, 7, 3], [40, 5, 2]], dtype=torch.int32)
    meta = torch.from_numpy(rng.integers(-2**31, 2**31, (4, 3)).astype(np.int32))
    ctoks = torch.from_numpy(rng.integers(-2**31, 2**31, (4, 6)).astype(np.int32))
    cnts = torch.tensor([3, 0, 1, 2], dtype=torch.int32)
    frames = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 12)).astype(np.int32))
    schema = Schema.from_json({"M": [["h", ["Bytes", 3]], ["v", ["Array", ["Bytes", 5]]]]})
    msg_wire = j_ser(JSchema.from_json({"M": [["h", ["Bytes", 3]],
                                              ["v", ["Array", ["Bytes", 5]]]]}),
                     {"h": 7, "v": [1, 2, 3]})
    plan = plan_from_wire(schema, msg_wire)
    lanes = ops.wire_to_u32(msg_wire, "cpu")
    wires = [msg_wire, msg_wire]
    flat, row = ops.wires_to_u32(wires, "cpu")
    bplan = batch_plans(schema, wires)
    return {
        "unpack_run": (lambda: pu.unpack_run(wire, 1, 5, 30, 5),
                       lambda: pu.unpack_run(wire_u32=wire, base=1, stride=5, count=30,
                                             nbytes=5, interpret=True)),
        "unpack_gather": (lambda: pu.unpack_gather(wire, offs, 7),
                          lambda: pu.unpack_gather(wire_u32=wire, offsets=offs, nbytes=7,
                                                   interpret=False)),
        "pack_run": (lambda: fp.pack_run(toks, 16, 11),
                     lambda: fp.pack_run(toks, 16, 11, interpret=True)),
        "stamp_headers": (lambda: fp.stamp_headers(wire, hdrs),
                          lambda: fp.stamp_headers(wire_u32=wire, headers=hdrs,
                                                   interpret=True)),
        "pack_frames_batch": (lambda: fp.pack_frames_batch(frames[:, :4], frames[:, 4:]),
                              lambda: fp.pack_frames_batch(frames[:, :4], frames[:, 4:],
                                                           interpret=True)),
        "unpack_frames_batch": (lambda: fp.unpack_frames_batch(frames),
                                lambda: fp.unpack_frames_batch(frames, block=8,
                                                               interpret=True)),
        "pack_chunks_batch": (lambda: fp.pack_chunks_batch(meta, ctoks, cnts[:, None]),
                              lambda: fp.pack_chunks_batch(meta, ctoks, cnts[:, None],
                                                           block=8, interpret=True)),
        "ops.decode_run": (lambda: ops.decode_run(wire, 4, 8, 7, 6),
                           lambda: ops.decode_run(wire, 4, 8, 7, 6, True)),
        "ops.decode_gather": (lambda: ops.decode_gather(wire, offs, 3),
                              lambda: ops.decode_gather(wire, offs, 3, interpret=True)),
        "ops.encode_run": (lambda: ops.encode_run(toks, 12, 12),
                           lambda: ops.encode_run(toks, 12, 12, True)),
        "ops.write_headers": (lambda: ops.write_headers(wire, hdrs),
                              lambda: ops.write_headers(wire_u32=wire, headers=hdrs,
                                                        interpret=True)),
        "ops.decode_frames_batch": (lambda: ops.decode_frames_batch(frames),
                                    lambda: ops.decode_frames_batch(frames, True)),
        "ops.encode_chunks_batch": (lambda: ops.encode_chunks_batch(meta, ctoks, cnts, 2),
                                    lambda: ops.encode_chunks_batch(meta, ctoks, cnts, 2,
                                                                    True)),
        "ops.decode_message_kernel": (lambda: ops.decode_message_kernel(lanes, plan),
                                      lambda: ops.decode_message_kernel(lanes, plan, None,
                                                                        True)),
        "ops.decode_batch_kernel": (lambda: ops.decode_batch_kernel(flat, row, bplan),
                                    lambda: ops.decode_batch_kernel(flat, row, bplan,
                                                                    interpret=True)),
    }


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(_keyword_calls()))
def test_reference_keywords_change_nothing(name):
    """A call written with the reference's keywords (``wire_u32=``,
    ``interpret=``, ``block=``) gives what the call without them gives."""
    plain, keyed = _keyword_calls()[name]
    assert _same(plain(), keyed())


def test_encode_frames_batch_sixth_positional_is_interpret():
    """``encode_frames_batch(p, n, r, 1, 16, True)`` means ``interpret=True``
    as in the reference: ``adaptive`` stays off (the route words' top bit)."""
    rng = np.random.default_rng(8)
    pay = rng.integers(0, 2**32, (3, 40), dtype=np.uint32)
    nbytes = np.array([160, 7, 0], np.int32)
    routes = np.array([[0, 1, 5], [2, 3, 65535], [1, 0, 0]], np.int32)
    got, n = ops.encode_frames_batch(_t(pay), nbytes, routes, 1, 16, True)
    plain, pn = ops.encode_frames_batch(_t(pay), nbytes, routes, 1, 16)
    want, wn = j_ops.encode_frames_batch(jnp.asarray(pay), jnp.asarray(nbytes),
                                         jnp.asarray(routes), 1, 16, True)
    assert torch.equal(got, plain) and torch.equal(n, pn)
    np.testing.assert_array_equal(lanes_u32(got), np.asarray(want))
    np.testing.assert_array_equal(n.numpy(), np.asarray(wn))
    assert not (lanes_u32(got)[..., 3] >> 31).any()
    adaptive, _ = ops.encode_frames_batch(_t(pay), nbytes, routes, 1, 16, True, True)
    assert (lanes_u32(adaptive)[..., 3] >> 31).all()
