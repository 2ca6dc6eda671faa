"""Port parity, streaming plane: ``repro_torch.stream`` and
``serve_requests_streaming`` against the JAX package.

The stream-fragment codec must equal the frozen golden burst and the
reference's bursts byte for byte; the B7 plain versions
(``pack_chunks_batch_plain``, the masked ``encode_chunks_batch``) are held
to the Pallas ``pack_chunks_batch`` in interpret mode and to the
reference's ``encode_chunks_batch``.  ``ChunkLane``/``StreamReader`` over
the port's fabric must produce the reference's events over the JAX fabric
(8 fake CPU devices from ``tests/conftest.py``).  The serving tests use the
smoke yi-6b cut to 2 layers, float32, TF32 off, with the reference's
parameters carried over: final wires, ``on_token`` order, overlap,
logprobs, backpressure with defection, and a blackout that recovers.
The multi-lane encoder (``encode_fragment_bursts``) must give every lane
the reference's burst, and ``flush_lanes`` the reference's sends.
Tokens and wires are compared bit for bit; float32 logprobs within
``atol=rtol=1e-5`` (torch and XLA may round the log-softmax differently in
the last ulp).  The CUDA kernel itself is held to its plain version on the
card by ``tests/test_torch_cuda.py``.
"""
import importlib
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.fabric import Fabric as JFabric
from repro.fabric import FabricConfig as JConfig
from repro.fabric import FaultPlan as JFaultPlan
from repro.kernels import frame_pack as jpack
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.launch.steps import cached_serve_steps as j_cached_serve_steps
from repro.runtime.scheduler import ContinuousBatcher as JBatcher
from repro.runtime.scheduler import SchedulerConfig as JSched
from repro import stream as jstream
from repro_torch import stream as tstream
from repro_torch.core import Schema, lanes_u32
from repro_torch.fabric import Fabric, FabricConfig, FaultPlan
from repro_torch.kernels import frame_pack as tpack
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.runtime.scheduler import ContinuousBatcher, SchedulerConfig
from torch_parity import twin_models

# the packages' ``core`` exports a function named ``stream_plans`` too
jsp = importlib.import_module("repro.core.stream_plans")
tsp = importlib.import_module("repro_torch.core.stream_plans")
GOLDEN = pathlib.Path(__file__).parent / "golden" / "token_chunks.bin"
LP_TOL = dict(atol=1e-5, rtol=1e-5)


def _frags(frags):
    """Fragments of either package as plain tuples."""
    return [(f.stream_id, f.step, f.tokens, f.eos, f.corrupt) for f in frags]


def _lanes(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# fragment codec: golden burst, typed plans, meta budgets
# ---------------------------------------------------------------------------


def _golden_chunks(chunk_cls):
    """The chunk mix ``tests/golden/token_chunks.bin`` was frozen from
    (as in ``tests/test_typed_streams.py``)."""
    rng = np.random.default_rng(1801)
    specs = [(0x0001_0000, 1, False), (0xFFFF_FFFF, 0, False), (7, 0, True),
             (0x0002_0003, 13, False), (42, 16, True), (0x1234_5678, 250, False)]
    chunks, step_per_sid = [], {}
    for sid, n, eos in specs:
        step = step_per_sid.get(sid, 0)
        toks = tuple(int(t) for t in rng.integers(0, 1 << 32, n, dtype=np.uint64))
        chunks.append(chunk_cls(sid, step, toks, eos))
        step_per_sid[sid] = step + 1
    return chunks


def test_chunk_burst_matches_golden_and_reference():
    golden = GOLDEN.read_bytes()
    chunks = _golden_chunks(tstream.TokenChunk)
    assert tstream.encode_chunk_burst(chunks, device="cpu") == golden
    assert jstream.encode_chunk_burst(_golden_chunks(jstream.TokenChunk)) == golden
    singles = b"".join(tstream.encode_token_chunk(c.stream_id, c.step, c.tokens, c.eos)
                       for c in chunks)
    assert singles == golden
    got, ok = tstream.decode_token_chunks(golden)
    assert ok and got == chunks
    assert tstream.encode_chunk_burst([], device="cpu") == b""


_PLANS = {
    "token": lambda m: m.token_stream_plan(),
    "logprob": lambda m: m.logprob_stream_plan(),
    "wide": None,  # a three-leaf element: Bytes 8, Bytes 2, Bytes 5 (2 + 1 + 2 words)
}
_WIDE = {"W": [["s", ["Stream", ["Struct", "E"]]]],
         "E": [["a", ["Bytes", 8]], ["b", ["Bytes", 2]], ["c", ["Bytes", 5]]]}


def _plan(name, stream_mod, plans_mod, schema_cls):
    if name == "wide":
        return plans_mod.stream_plans(schema_cls.from_json(_WIDE))["s"]
    return _PLANS[name](stream_mod)


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_typed_burst_matches_reference(name):
    from repro.core import Schema as JSchema

    plan = _plan(name, tstream, tsp, Schema)
    jplan = _plan(name, jstream, jsp, JSchema)
    assert plan.elem_words == jplan.elem_words
    rng = np.random.default_rng(5)
    frags = []
    for i, n in enumerate([3, 0, 1, 9, 4]):
        if plan.n_leaves == 1:
            toks = tuple(int(t) for t in rng.integers(0, 1 << 32, n, dtype=np.uint64))
        else:
            toks = tuple(tuple(int(rng.integers(0, 1 << (8 * nb), dtype=np.uint64))
                               for nb in plan.leaf_nbytes)
                         for _ in range(n))
        frags.append(tsp.Fragment(1000 + i % 2, i // 2, toks, eos=(i == 4)))
    want = jsp.encode_fragment_burst(jplan, frags)
    assert tsp.encode_fragment_burst(plan, frags, device="cpu") == want
    assert want == b"".join(jsp.encode_fragment(jplan, f.stream_id, f.step, f.tokens, f.eos)
                            for f in frags)
    got, ok = tsp.decode_fragments(plan, want)
    assert ok and _frags(got) == _frags(jsp.decode_fragments(jplan, want)[0])
    assert _frags(got) == _frags(frags)


@pytest.mark.parametrize("sid,step,flags_bad", [(1 << 32, 0, False), (-1, 0, False),
                                               (5, 1 << 16, False), (5, -3, False)])
def test_meta_budget_errors_identical(sid, step, flags_bad):
    frags = [tstream.TokenChunk(1, 0, (7,)), tstream.TokenChunk(sid, step, (1, 2))]
    with pytest.raises(ValueError) as want:
        jsp.encode_fragment_burst(jstream.token_stream_plan(), frags)
    with pytest.raises(ValueError) as got:
        tsp.encode_fragment_burst(tstream.token_stream_plan(), frags, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jstream.encode_token_chunk(sid, step, (1,))
    with pytest.raises(ValueError) as got:
        tstream.encode_token_chunk(sid, step, (1,))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("id_bits,step_bits", [(0, 16), (33, 16), (32, 0), (16, 40)])
def test_plan_budget_errors_identical(id_bits, step_bits):
    from repro.core import Schema as JSchema
    from repro.core import SchemaError as JSchemaError
    from repro_torch.core import SchemaError

    with pytest.raises(JSchemaError) as want:
        jsp.stream_plans(JSchema.from_json(jstream.TOKEN_STREAM_SCHEMA_JSON),
                         id_bits=id_bits, step_bits=step_bits)
    with pytest.raises(SchemaError) as got:
        tsp.stream_plans(Schema.from_json(tstream.TOKEN_STREAM_SCHEMA_JSON),
                         id_bits=id_bits, step_bits=step_bits)
    assert str(got.value) == str(want.value)


def test_decode_round_trip_and_corrupt_flags():
    """Out-of-budget meta decodes with ``corrupt=True``; truncation flags
    the burst; both exactly as the reference parses them."""
    plan, jplan = tstream.token_stream_plan(), jstream.token_stream_plan()
    good = tstream.encode_token_chunk(3, 0, (9, 8)) + tstream.encode_token_chunk(3, 1, (7,))
    bad_step = bytearray(good)
    bad_step[4:8] = (1 << 20).to_bytes(4, "little")  # step past the u16 budget
    bad_flags = bytearray(good)
    bad_flags[8:12] = (0x6).to_bytes(4, "little")  # unknown flag bits
    for wire in (good, bytes(bad_step), bytes(bad_flags), good[:-2], good[:8]):
        got, ok = tsp.decode_fragments(plan, wire)
        want, jok = jsp.decode_fragments(jplan, wire)
        assert (_frags(got), ok) == (_frags(want), jok)
    assert tsp.decode_fragments(plan, bytes(bad_step))[0][0].corrupt


# ---------------------------------------------------------------------------
# B7: plain versions against the Pallas kernel (interpret) and the
# reference's encode_chunks_batch
# ---------------------------------------------------------------------------


def _chunk_inputs(B, cap, ew, seed):
    rng = np.random.default_rng(seed)
    meta = _u32(rng, (B, 3))
    toks = _u32(rng, (B, cap * ew))
    counts = rng.integers(0, cap + 1, B).astype(np.uint32)
    if B:
        counts[0] = cap  # a full row and an empty one at every B >= 2
        counts[-1] = 0 if B > 1 else counts[-1]
    return meta, toks, counts


@pytest.mark.parametrize("ew", [1, 2, 3])
@pytest.mark.parametrize("cap", [1, 4, 64])
@pytest.mark.parametrize("B", [0, 1, 7, 8, 33])
def test_chunk_kernel_plain_matches_reference(B, cap, ew):
    meta, toks, counts = _chunk_inputs(B, cap, ew, seed=B * 100 + cap * 10 + ew)
    want = np.asarray(jops.encode_chunks_batch(meta, toks, counts, elem_words=ew))
    got = ops.encode_chunks_batch(_lanes(meta), _lanes(toks), _lanes(counts), elem_words=ew)
    np.testing.assert_array_equal(lanes_u32(got), want)
    # the unmasked form on pre-masked words: the Pallas body's contract
    col = np.arange(cap * ew)[None, :]
    masked = np.where(col < counts[:, None].astype(np.int64) * ew, toks, 0).astype(np.uint32)
    plain = tpack.pack_chunks_batch_plain(_lanes(meta), _lanes(masked), _lanes(counts[:, None]))
    np.testing.assert_array_equal(lanes_u32(plain), want)
    assert torch.equal(tpack.pack_chunks_batch(_lanes(meta), _lanes(masked),
                                               _lanes(counts[:, None])), plain)
    # the Pallas kernel itself in interpret mode, on raw (unmasked) words
    pallas = np.asarray(jpack.pack_chunks_batch(
        jnp.asarray(meta), jnp.asarray(toks), jnp.asarray(counts[:, None])))
    raw = tpack.pack_chunks_batch_plain(_lanes(meta), _lanes(toks), _lanes(counts[:, None]))
    np.testing.assert_array_equal(lanes_u32(raw), pallas)


def test_chunk_kernel_wrapper_checks():
    m, t, c = (_lanes(np.zeros(s, np.uint32)) for s in ((2, 3), (2, 4), (2, 1)))
    with pytest.raises(ValueError, match=r"\(B, 3\)"):
        tpack.pack_chunks_batch(m, t, c[:1])
    with pytest.raises(ValueError, match="elem_words"):
        ops.encode_chunks_batch(m, t, c[:, 0], elem_words=0)
    with pytest.raises(ValueError, match="int32"):
        tpack.pack_chunks_batch(m.long(), t, c)
    assert tpack.pack_chunks_batch(m[:0], t[:0], c[:0]).shape == (0, 8)


# ---------------------------------------------------------------------------
# ChunkLane / StreamReader over the fabric, against the reference
# ---------------------------------------------------------------------------


def _event(ev):
    return (ev.src, ev.stream_id, ev.step, tuple(ev.tokens), ev.eos, ev.ok, ev.arrive_step)


def _lane_run(fab, lane_cls, reader_cls, lp_plan):
    """Two shards stream interleaved token streams to rank 0, shard 5's
    lane clamped (trickling one chunk per flush) for ticks 1-3; shard 3
    also streams (tok, logprob bits) elements on a logprob-plan lane.
    Returns every event in arrival order."""
    rng = np.random.default_rng(11)
    lanes = {2: lane_cls(fab.mailbox(2), 0, list_level=1),
             5: lane_cls(fab.mailbox(5), 0, list_level=2, p95_threshold=1.0)}
    lp_lane = lane_cls(fab.mailbox(3), 0, list_level=3, plan=lp_plan)
    writers = {(s, sid): lanes[s].writer(sid) for s in lanes for sid in (10, 11)}
    lp_writer = lp_lane.writer(77)
    lens = {(2, 10): 5, (2, 11): 2, (5, 10): 4, (5, 11): 3}
    reader, lp_reader = reader_cls(), reader_cls(plan=lp_plan)
    events = []
    for step in range(7):
        lanes[5].feedback(5.0 if 1 <= step <= 3 else 0.0)
        for key, w in writers.items():
            if step < lens[key]:
                w.write(list(map(int, rng.integers(0, 1 << 31, 2))),
                        eos=(step == lens[key] - 1))
        if step < 3:
            lp_writer.write([(int(rng.integers(0, 64000)),
                              int(np.float32(-rng.random()).view(np.uint32)))],
                            eos=(step == 2))
        for lane in (*lanes.values(), lp_lane):
            lane.flush()
        fab.exchange()
        got = fab.mailbox(0).recv()
        events += [_event(e) for e in reader.feed([d for d in got if d.list_level != 3])]
        events += [_event(e) for e in lp_reader.feed([d for d in got if d.list_level == 3])]
    assert lanes[5].holds >= 2
    return events, {k: (st.tokens, st.eos, st.ok) for k, st in reader.streams.items()}


def test_chunk_lane_reader_match_reference():
    jfab = JFabric(n_ranks=8, config=JConfig(frame_phits=2, credits=2))
    fab = Fabric(n_ranks=8, config=FabricConfig(frame_phits=2, credits=2), device="cpu")
    want = _lane_run(jfab, jstream.ChunkLane, jstream.StreamReader,
                     jstream.logprob_stream_plan())
    got = _lane_run(fab, tstream.ChunkLane, tstream.StreamReader,
                    tstream.logprob_stream_plan())
    assert got == want
    assert all(eos and ok for _, eos, ok in got[1].values()) and len(got[0]) >= 15


# ---------------------------------------------------------------------------
# serving: logprob steps, batcher, serve_requests_streaming
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """The smoke yi-6b cut to 2 layers in both packages (same parameters),
    four requests of two prompts, and the port's batched-plane answer."""
    jcfg, jparams, cfg, tparams = twin_models("yi-6b", n_layers=2)
    r = np.random.default_rng(0)
    wires = [tserve.encode_request(i, [list(map(int, r.integers(2, cfg.vocab, 12)))
                                       for _ in range(2)]) for i in range(4)]
    kw = dict(max_new=4, pad_to=8, slots=4)
    base = tserve.serve_requests(tparams, cfg, wires, device="cpu", **kw)
    return jcfg, jparams, cfg, tparams, wires, kw, base


def test_logprob_steps_match_reference(setup):
    """Greedy tokens identical to the logprob-free steps and to the
    reference; logprobs allclose.  The reference's jitted steps are the
    memoized ones the streaming serve uses (admit width 4, cache 12)."""
    jcfg, jparams, cfg, tparams, *_ = setup
    rng = np.random.default_rng(4)
    toks = rng.integers(2, cfg.vocab, (4, 8)).astype(np.int32)
    jprefill, jstep = j_cached_serve_steps(jcfg, cache_len=12, logprobs=True)
    jt, jlp, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    tt, tlp, tcache = make_prefill_step(cfg, cache_len=12, logprobs=True)(
        tparams, {"tokens": torch.from_numpy(toks)})
    t_plain, _ = make_prefill_step(cfg, cache_len=12)(tparams, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(tt, t_plain)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **LP_TOL)
    tstep = make_serve_step(cfg, logprobs=True)
    for _ in range(3):
        jt, jlp, jcache = jstep(jparams, jcache, jt)
        tt, tlp, tcache = tstep(tparams, tcache, tt)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **LP_TOL)
        assert bool((tlp <= 0).all())


def test_batcher_logprobs_match_reference(setup):
    """Emissions identical with and without logprobs and to the reference;
    each tick's logprobs allclose to the reference's; the logprob column
    rides the one host sync per tick."""
    from repro_torch.obs import MetricsRegistry

    jcfg, jparams, cfg, tparams, *_ = setup
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(2, cfg.vocab, rng.integers(4, 8)))) for _ in range(5)]
    kw = dict(slots=4, prompt_cap=8, max_new=4, admit_cap=2)
    jb = JBatcher(jparams, jcfg, JSched(**kw), logprobs=True)
    reg = MetricsRegistry()
    tb = ContinuousBatcher(tparams, cfg, SchedulerConfig(**kw), metrics=reg, logprobs=True)
    plain = ContinuousBatcher(tparams, cfg, SchedulerConfig(**kw))
    for i, p in enumerate(prompts):
        for b in (jb, tb, plain):
            b.submit(i, p)
    while jb.pending or jb.n_active:
        for b in (jb, tb, plain):
            b.step_begin()
        want = jb.step_finish()
        assert tb.step_finish() == want == plain.step_finish()
        assert tb.tick_logprobs.keys() == jb.tick_logprobs.keys()
        keys = sorted(jb.tick_logprobs, key=str)
        np.testing.assert_allclose([tb.tick_logprobs[k] for k in keys],
                                   [jb.tick_logprobs[k] for k in keys], **LP_TOL)
    assert tb.done == jb.done
    counters = {m["name"]: m["value"] for m in reg.snapshot()["metrics"]
                if m["type"] == "counter"}
    assert counters["batcher.admitted"] == counters["batcher.evicted"] == 5
    assert counters["batcher.steps"] == tb.steps_run


def test_streaming_serve_matches_reference(setup):
    """n_shards=3, ARQ (the serving default): final wires equal the
    reference's streaming wires and the port's batched plane, and the
    ``on_token`` events arrive in the reference's order."""
    jcfg, jparams, cfg, tparams, wires, kw, base = setup
    jev, tev = [], []
    want = jserve.serve_requests_streaming(jparams, jcfg, wires, n_shards=3,
                                           on_token=lambda *e: jev.append(e), **kw)
    fab = tserve.default_serve_fabric(3, device="cpu")
    got = tserve.serve_requests_streaming(tparams, cfg, wires, fabric=fab, device="cpu",
                                          on_token=lambda *e: tev.append(e), **kw)
    assert got == want == base
    assert tev == [tuple(int(v) for v in e) for e in jev] and len(tev) == 4 * 2 * 4
    per_seq = {}
    for m, j, step, tok in tev:
        assert step == len(per_seq.setdefault((m, j), []))
        per_seq[(m, j)].append(tok)


def test_streaming_overlap_off_identical(setup):
    _, _, cfg, tparams, wires, kw, base = setup
    ev = {True: [], False: []}
    for overlap in (True, False):
        got = tserve.serve_requests_streaming(
            tparams, cfg, wires, n_shards=2, overlap=overlap, device="cpu",
            on_token=lambda *e, o=overlap: ev[o].append(e), **kw)
        assert got == base
    assert sorted(ev[True]) == sorted(ev[False])


def test_streaming_logprobs_match_reference(setup):
    jcfg, jparams, cfg, tparams, wires, kw, base = setup
    out = {}
    for name, fn, p, c, dev in (("ref", jserve.serve_requests_streaming, jparams, jcfg, {}),
                                ("port", tserve.serve_requests_streaming, tparams, cfg,
                                 {"device": "cpu"})):
        toks, lps = {}, {}
        wires_out = fn(p, c, wires, n_shards=2, logprobs=True,
                       on_token=lambda m, j, s, t, d=toks: d.setdefault((m, j), []).append(t),
                       on_logprob=lambda m, j, s, t, lp, d=lps: d.setdefault(
                           (m, j), []).append((t, lp)),
                       **dev, **kw)
        out[name] = (wires_out, toks, lps)
    (jw, jtoks, jlps), (tw, ttoks, tlps) = out["ref"], out["port"]
    assert tw == jw == base
    assert ttoks == jtoks and set(tlps) == set(jlps) == set(ttoks)
    for key, pairs in tlps.items():
        assert [t for t, _ in pairs] == ttoks[key] == [t for t, _ in jlps[key]]
        lp = np.array([v for _, v in pairs], np.float32)
        assert np.isfinite(lp).all() and (lp <= 0).all()
        np.testing.assert_allclose(lp, [v for _, v in jlps[key]], **LP_TOL)


def test_streaming_backpressure_and_defection_match_reference(setup):
    """Threshold 0 clamps every lane from its first observation, and
    direction defection is on: the same events and wires as the reference."""
    jcfg, jparams, cfg, tparams, wires, kw, base = setup
    extra = dict(n_shards=3, qos_levels=[1 + (i % 2) for i in range(len(wires))],
                 defect_after=1, backpressure_p95=0.0)
    jev, tev = [], []
    want = jserve.serve_requests_streaming(jparams, jcfg, wires, on_event=jev.append,
                                           **extra, **kw)
    got = tserve.serve_requests_streaming(tparams, cfg, wires, on_event=tev.append,
                                          device="cpu", **extra, **kw)
    assert got == want == base
    assert [_event(e) for e in tev] == [_event(e) for e in jev]
    assert tev and all(e.arrive_step is not None for e in tev)


def test_streaming_blackout_recovers_like_reference(setup):
    """Shard 2 goes dark from tick 2, mid-stream: the ingress suspects it,
    abandons its streams, re-sends its requests once, and the answers stay
    byte-identical, with the reference's recovery counters and tick count."""
    jcfg, jparams, cfg, tparams, wires, kw, base = setup
    plan = dict(seed=7, blackout_rank=2, blackout_from=2, blackout_ticks=1 << 20)
    extra = dict(placement=[1, 2, 3, 2], suspect_after=4, **kw)
    jfab = jserve.default_serve_fabric(3, faults=JFaultPlan(**plan))
    want = jserve.serve_requests_streaming(jparams, jcfg, wires, fabric=jfab, **extra)
    fab = tserve.default_serve_fabric(3, faults=FaultPlan(**plan), device="cpu")
    got = tserve.serve_requests_streaming(tparams, cfg, wires, fabric=fab, device="cpu",
                                          **extra)
    assert got == want == base

    def counters(f):
        return {m["name"]: m["value"] for m in f.metrics.snapshot()["metrics"]
                if m["type"] == "counter" and m["name"].startswith("serve.")}

    assert counters(fab) == counters(jfab)
    assert counters(fab)["serve.suspects"] >= 1 and counters(fab)["serve.retries"] >= 1
    assert fab.ticks == jfab.ticks


def test_streaming_fallback_and_unported_hooks(setup):
    _, _, cfg, tparams, wires, kw, base = setup
    got = tserve.serve_requests_streaming(tparams, cfg, wires, device="cpu",
                                          fabric=Fabric(n_ranks=1, device="cpu"), **kw)
    assert got == base
    from repro_torch.obs import SpanTracker, TraceRecorder

    trace, spans = TraceRecorder(), SpanTracker()
    got = tserve.serve_requests_streaming(tparams, cfg, wires, device="cpu", analyze=True,
                                          trace=trace, spans=spans,
                                          fabric=Fabric(n_ranks=1, device="cpu"), **kw)
    assert got == base
    # the one-rank fallback is the batched plane, as in the reference: no
    # request was traced
    assert trace.events == [] and spans.requests() == []
    with pytest.raises(ValueError, match="reserved logprob"):
        tserve.serve_requests_streaming(tparams, cfg, wires, device="cpu", n_shards=2,
                                        logprobs=True, qos_levels=[254] * 4, **kw)


def test_cli_streaming_on_cpu(capsys):
    tserve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--n-requests", "3",
                 "--n-prompts", "2", "--max-new", "3", "--pad-to", "8", "--slots", "2",
                 "--streaming", "--n-shards", "3", "--logprobs", "--no-overlap",
                 "--backpressure-p95", "4"])
    out = capsys.readouterr().out
    assert "streaming(slots=2): 3 requests, 18 tokens" in out
    assert "time-to-first-token" in out
    assert "logprob side-stream: 18 events" in out


# ---------------------------------------------------------------------------
# one launch per tick: the multi-burst encoder and flush_lanes
# ---------------------------------------------------------------------------


def _burst_items(case, plans_mod, stream_mod, schema_cls):
    """(plan, fragments) per lane, built alike for either package: token
    and logprob lanes, an empty lane, EOS-only fragments and a five-word
    element plan."""
    rng = np.random.default_rng(len(case))
    tp, lp = stream_mod.token_stream_plan(), stream_mod.logprob_stream_plan()
    wide = _plan("wide", stream_mod, plans_mod, schema_cls)
    lanes = {"mixed": [tp, lp, tp, lp], "empty lanes": [tp, lp, tp],
             "eos only": [tp, lp], "wide": [wide, tp, wide], "one lane": [lp]}[case]
    items = []
    for i, plan in enumerate(lanes):
        n_frags = 0 if case == "empty lanes" and i != 1 else int(rng.integers(1, 7))
        frags = []
        for k in range(n_frags):
            n = 0 if case == "eos only" else int(rng.integers(0, 5))
            if plan.n_leaves == 1:
                toks = tuple(int(t) for t in rng.integers(0, 1 << 32, n, dtype=np.uint64))
            else:
                toks = tuple(tuple(int(rng.integers(0, 1 << (8 * nb), dtype=np.uint64))
                                   for nb in plan.leaf_nbytes) for _ in range(n))
            frags.append(plans_mod.Fragment((i << 16) | k, k, toks,
                                            eos=(case == "eos only" or k == n_frags - 1)))
        items.append((plan, frags))
    return items


@pytest.mark.parametrize("case", ["mixed", "empty lanes", "eos only", "wide", "one lane"])
def test_fragment_bursts_match_reference(case, monkeypatch):
    """``encode_fragment_bursts`` gives each lane the reference's
    ``encode_fragment_burst`` bytes (and ``encode_chunk_burst``'s for token
    lanes), packing all lanes in one call of the trimmed form."""
    from repro.core import Schema as JSchema

    items = _burst_items(case, tsp, tstream, Schema)
    jitems = _burst_items(case, jsp, jstream, JSchema)
    calls = []
    inner = ops.encode_chunks_trimmed
    monkeypatch.setattr(ops, "encode_chunks_trimmed", lambda *a: (calls.append(1), inner(*a))[1])
    got = tsp.encode_fragment_bursts(items, device="cpu")
    want = [jsp.encode_fragment_burst(p, f) if f else b"" for p, f in jitems]
    assert got == want and len(calls) == (1 if any(f for _, f in items) else 0)
    for (plan, frags), burst in zip(jitems, want):
        if plan is jstream.token_stream_plan():
            chunks = [jstream.TokenChunk(f.stream_id, f.step, f.tokens, f.eos) for f in frags]
            assert burst == (jstream.encode_chunk_burst(chunks) if chunks else b"")
        assert burst == tsp.encode_fragment_burst(plan, frags, device="cpu")
    assert tsp.encode_fragment_bursts([], device="cpu") == []


def test_fragment_bursts_validate_before_packing(monkeypatch):
    """A bad fragment in any lane raises the reference's message before
    anything is packed."""
    plan = tstream.token_stream_plan()
    monkeypatch.setattr(ops, "encode_chunks_trimmed",
                        lambda *a: pytest.fail("packed before validating"))
    good = [tstream.TokenChunk(1, 0, (7,))]
    bad = [tstream.TokenChunk(2, 1 << 16, (1, 2))]
    with pytest.raises(ValueError) as want:
        jsp.encode_fragment_burst(jstream.token_stream_plan(), bad)
    with pytest.raises(ValueError) as got:
        tsp.encode_fragment_bursts([(plan, good), (plan, bad)], device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exceeds"):
        tsp.encode_fragment_bursts([(plan, [tstream.TokenChunk(1, 0, (0,) * (1 << 16))])],
                                   device="cpu")


class _Box:
    """A mailbox that records its sends (the lanes' only use of it)."""

    def __init__(self, rank, log):
        self.rank, self.log = rank, log
        self.fabric = type("F", (), {"router": type("R", (), {"device": torch.device("cpu")})})

    def send(self, dst, wire, list_level=1):
        self.log.append((self.rank, dst, bytes(wire), list_level))


def _flush_run(lane_mod, stream_mod, scenario, flush):
    """Lanes of two shards (token plans at two levels, one of them clamped,
    a logprob lane, an empty lane) over 8 ticks, then the drain; returns the
    sends in order, what each flush returned, and the lanes' counters."""
    rng = np.random.default_rng(21)
    log = []
    clamp = {"trickle": dict(clamp_chunks=1), "hold": dict(clamp_chunks=0, max_hold=2),
             "unclamped": dict(clamp_chunks=1)}[scenario]
    lanes = [lane_mod.ChunkLane(_Box(1, log), 0, list_level=1),
             lane_mod.ChunkLane(_Box(2, log), 0, list_level=2, p95_threshold=1.0, **clamp),
             lane_mod.ChunkLane(_Box(1, log), 0, list_level=254,
                                plan=stream_mod.logprob_stream_plan()),
             lane_mod.ChunkLane(_Box(3, log), 0, list_level=1)]
    writers = [lanes[i].writer(sid) for i in (0, 1, 2) for sid in (5, 6)]
    sent = []
    for tick in range(8):
        lanes[1].feedback(9.0 if scenario != "unclamped" and 1 <= tick <= 5 else 0.0)
        for w in writers:
            if not w.closed and rng.random() < 0.8:
                elems = ([(int(rng.integers(0, 64000)), int(rng.integers(0, 2**32)))]
                         if w.lane is lanes[2] else [int(rng.integers(0, 64000))])
                w.write(elems, eos=tick >= 6 and rng.random() < 0.5)
        sent.append(flush(lanes, False))
    sent.append(flush(lanes, True))
    return log, sent, [(lane.holds, lane.flushes, len(lane._pending)) for lane in lanes]


@pytest.mark.parametrize("scenario", ["trickle", "hold", "unclamped"])
def test_flush_lanes_sends_as_lane_flushes(scenario):
    """``flush_lanes`` makes the same ``mailbox.send`` calls, in the same
    order, with the same counts and lane state, as ``ChunkLane.flush`` on
    each lane in turn, in the port and in the reference."""
    from repro_torch.stream import plane as tplane

    def one_by_one(lanes, force):
        return sum(lane.flush(force=force) for lane in lanes)

    want = _flush_run(jstream, jstream, scenario, one_by_one)
    assert _flush_run(tplane, tstream, scenario, one_by_one) == want
    assert _flush_run(tplane, tstream, scenario, tplane.flush_lanes) == want
    log, sent, state = want
    assert len(log) > 8 and sum(sent) > 0
    if scenario != "unclamped":
        assert state[1][0] >= 2  # the clamped lane held chunks back
