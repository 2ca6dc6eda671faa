"""Port parity, host core: the copied SER/DES modules and the structure pass.

The same schemas and messages go through ``repro.core`` (JAX package) and
``repro_torch.core`` (the port); ROM words, ``ser_sw_to_hw`` wires,
``DesFSM``/``SerFSM`` tokens and wires, ``batch_plans`` offsets and counts
must come out identical, and the torch payload pass must equal the jnp one
bit for bit (including padding rows: both clip to the wire's last byte).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import repro.core as jc
import repro.data.schemas as jschemas
import repro_torch.core as tc
import repro_torch.data.schemas as tschemas

ROM_FIELDS = ("kind", "nbytes", "child", "last", "tag", "tag_start", "tag_end",
              "emit_end", "list_level", "depth")


def _random_schema_json(rng):
    """A seeded random schema: Bytes/Array/List/Struct nesting, 1-4 fields."""

    def typ(depth):
        kinds = ["bytes"] * 3 + (["array", "list", "struct"] if depth < 3 else [])
        k = kinds[int(rng.integers(len(kinds)))]
        if k == "bytes":
            return ["Bytes", int(rng.choice([1, 2, 3, 4, 8, 13, 16]))]
        if k == "array":
            return ["Array", typ(depth + 1)]
        if k == "list":
            return ["List", typ(depth + 1)]
        return ["Struct", f"S{depth + 1}"]

    obj = {}
    for d in (3, 2, 1):
        obj[f"S{d}"] = [
            [f"g{d}_{i}", ["Bytes", int(rng.choice([1, 2, 4]))] if d == 3 else typ(d)]
            for i in range(int(rng.integers(1, 4)))
        ]
    fields = [[f"f{i}", typ(0)] for i in range(int(rng.integers(1, 5)))]
    return {"Msg": fields, **obj}


def _schema_corpus():
    rng = np.random.default_rng(7)
    out = [("request", lambda m: m.request_schema()),
           ("response", lambda m: m.response_schema()),
           ("batch", lambda m: m.batch_schema(8))]
    for i in range(10):
        obj = _random_schema_json(rng)
        out.append((f"random{i}", lambda m, obj=obj: m.Schema.from_json(obj)))
    return out


CORPUS = _schema_corpus()


def _pair(make):
    """(JAX-package schema, port schema) from one constructor."""
    jns = type("J", (), {"Schema": jc.Schema, "request_schema": jschemas.request_schema,
                         "response_schema": jschemas.response_schema,
                         "batch_schema": jschemas.batch_schema})
    tns = type("T", (), {"Schema": tc.Schema, "request_schema": tschemas.request_schema,
                         "response_schema": tschemas.response_schema,
                         "batch_schema": tschemas.batch_schema})
    return make(jns), make(tns)


def _tok(ts):
    return [(t.kind, t.value, t.tag, t.path) for t in ts]


@pytest.mark.parametrize("name,make", CORPUS, ids=[c[0] for c in CORPUS])
def test_rom_words_identical(name, make):
    js, ts = _pair(make)
    jr, tr = jc.build_rom(js), tc.build_rom(ts)
    for f in ROM_FIELDS:
        np.testing.assert_array_equal(getattr(jr, f), getattr(tr, f), err_msg=f)
    assert jr.paths == tr.paths and jr.stack_depth == tr.stack_depth


@pytest.mark.parametrize("name,make", CORPUS, ids=[c[0] for c in CORPUS])
def test_wires_and_fsm_tokens_identical(name, make):
    js, ts = _pair(make)
    jr, tr = jc.build_rom(js), tc.build_rom(ts)
    for seed in range(3):
        msg = jc.random_message(js, np.random.default_rng(seed), max_elems=4)
        assert tc.random_message(ts, np.random.default_rng(seed), max_elems=4) == msg
        wire = jc.ser_sw_to_hw(js, msg)
        assert tc.ser_sw_to_hw(ts, msg) == wire
        jd, td = jc.DesFSM(jr, "sw2hw").run(wire), tc.DesFSM(tr, "sw2hw").run(wire)
        assert _tok(td.tokens) == _tok(jd.tokens) and td.cycles == jd.cycles
        toks = tc.strip_for_ser(tc.msg_to_des_tokens(ts, msg))
        assert _tok(toks) == _tok(jc.strip_for_ser(jc.msg_to_des_tokens(js, msg)))
        hw2sw = tc.SerFSM(tr, "hw2sw").run(toks)
        assert hw2sw.wire == jc.SerFSM(jr, "hw2sw").run(toks).wire
        assert tc.des_hw_to_sw(ts, hw2sw.wire) == msg
        framed = tc.SerFSM(tr, "hw2hw", frame_phits=2).run(toks)
        assert framed.wire == jc.SerFSM(jr, "hw2hw", frame_phits=2).run(toks).wire


def _request_wires(rng, n=6):
    """Ragged batch: a zero-prompt request and empty token lists included."""
    n_prompts = [0, 1, 3, 5, 2, 4]
    wires = []
    for m in range(n):
        msg = {"req_id": 100 + m, "prompts": [
            {"tokens": list(map(int, rng.integers(0, 2**31, rng.integers(0, 9))))}
            for _ in range(n_prompts[m % len(n_prompts)])
        ]}
        wires.append(jc.ser_sw_to_hw(jschemas.request_schema(), msg))
    return wires


def _batch_wires(rng, n=5, seq=8):
    rows = [{"tokens": list(map(int, rng.integers(0, 2**31, seq))),
             "segids": list(map(int, rng.integers(0, 4, seq)))} for _ in range(3)]
    return [jc.ser_sw_to_hw(jschemas.batch_schema(seq), {"rows": rows}) for _ in range(n)]


@pytest.mark.parametrize("kind", ["request", "batch"])
def test_batch_plans_identical(kind):
    rng = np.random.default_rng(3)
    if kind == "request":
        wires, js, ts = _request_wires(rng), jschemas.request_schema(), tschemas.request_schema()
    else:
        wires, js, ts = _batch_wires(rng), jschemas.batch_schema(8), tschemas.batch_schema(8)
    jp, tp = jc.batch_plans(js, wires), tc.batch_plans(ts, wires)
    assert set(jp.offsets) == set(tp.offsets)
    for p in jp.offsets:
        np.testing.assert_array_equal(jp.offsets[p], tp.offsets[p], err_msg=p)
        np.testing.assert_array_equal(jp.counts[p], tp.counts[p], err_msg=p)
        assert jp.nbytes[p] == tp.nbytes[p]
    np.testing.assert_array_equal(jp.wire_lens, tp.wire_lens)
    for i, w in enumerate(wires):
        caps = {p: jp.cap(p) for p in jp.offsets}
        a, b = jc.plan_from_wire(js, w, caps=caps), tc.plan_from_wire(ts, w, caps=caps)
        assert a.counts == b.counts and a.wire_len == b.wire_len
        for p in a.offsets:
            np.testing.assert_array_equal(a.offsets[p], b.offsets[p])


@pytest.mark.parametrize("kind", ["request", "batch"])
def test_decode_batch_identical(kind):
    """The torch payload pass equals the jnp one on every row."""
    rng = np.random.default_rng(4)
    if kind == "request":
        wires, js = _request_wires(rng), jschemas.request_schema()
    else:
        wires, js = _batch_wires(rng), jschemas.batch_schema(8)
    bp = jc.batch_plans(js, wires)
    mat = jc.stack_wires(wires)
    want = jc.decode_batch(jnp.asarray(mat), bp)
    got = tc.decode_batch(torch.from_numpy(mat), bp)
    for p in want:
        np.testing.assert_array_equal(tc.lanes_u32(got[p]), np.asarray(want[p]), err_msg=p)


def test_decode_message_and_lanes_to_int_identical():
    rng = np.random.default_rng(5)
    js = jschemas.request_schema()
    for w in _request_wires(rng)[1:4]:
        plan = jc.plan_from_wire(js, w)
        want = jc.decode_message(jc.wire_to_u8(w), plan)
        got = tc.decode_message(tc.wire_to_u8(w, "cpu"), plan)
        for p in want:
            np.testing.assert_array_equal(tc.lanes_u32(got[p]), np.asarray(want[p]))
            nb = plan.nbytes[p]
            assert list(tc.lanes_to_int(got[p], nb)) == list(
                jc.lanes_to_int(np.asarray(want[p]), nb))
