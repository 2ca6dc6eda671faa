"""Program spans and counters (``repro_torch.obs.timeline``) on the CPU.

Without a recorder a span is the shared no-op: no event, no CUDA event,
no ``record_function``, nothing read back, even under the profiler.  With
one, spans nest with parent ids, device times and intervals are filled
by ``resolve``, the recorder's anchor lays a span onto the Unix-epoch
clock of ``torch.profiler``, and the profiler's ``hgum.*`` ranges lie
inside their spans.  The batched plane answers byte for byte as without a
trace, its spans tile a call, the MoE counters equal the layer's own drop
share, and the serve CLI's batched mode writes the spans and counters.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import Counter
from unittest import mock

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import ffn as tffn
from repro_torch.models.model import init_params
from repro_torch.obs import MetricsRegistry, SpanTracker, TraceRecorder, validate_trace
from repro_torch.obs import timeline as tl
import torch_parity  # noqa: F401 (process setup: a share of the cores, TF32 off)

_KW = dict(max_new=4, pad_to=16, slots=4, device="cpu")


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("yi-6b", "mixtral-8x22b"):
        cfg = dataclasses.replace(smoke_config(get_config(arch)), n_layers=2)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out[arch] = (cfg, params, tserve.synthetic_wires(cfg, 3, 2, 0))
    return out


def _by_name(trace):
    out = {}
    for e in trace.events:
        if e["ph"] == "X":
            out.setdefault(e["name"], []).append(e)
    return out


# ---------------------------------------------------------------------------
# the helper
# ---------------------------------------------------------------------------


def test_null_span_is_shared_and_inert():
    a = tl.span(None, "x", device=torch.device("cpu"), slot=3)
    assert a is tl.span(None, "y") is tl.NULL_SPAN
    with a as s:
        assert s.begin() is s and s.id is None
        s.interval("gap_ms", 1, 2)
        s.end()
    assert tl.mark(None, "cuda") is None and tl.current() is None
    tl.count(None, "c", torch.tensor(1))
    tl.resolve(None)


def test_nesting_parents_and_counts():
    tr = TraceRecorder()
    with tl.span(tr, "root", wires=2) as root:
        assert tl.current() is tr
        with tl.span(tl.current(), "a", device=torch.device("cpu")) as a:
            tl.count(tl.current(), "n", torch.tensor(3))
            tl.count(tl.current(), "n", 2)
            with tl.span(tl.current(), "a.b"):
                tl.count(tl.current(), "m", 1)
        tick = tl.span(tr, "tick").begin()
        t0 = tl.mark(tr, "cpu")
        time.sleep(0.002)
        tick.interval("gap_ms", t0, tl.mark(tr, "cpu"))
        with tl.span(tr, "child", parent=tick):
            pass
        tick.end()
    assert tl.current() is None
    tl.count(tr, "n", 1)  # outside every span: the total only
    reg = MetricsRegistry()
    tl.resolve(tr, reg)
    ev = _by_name(tr)
    ids = {n: v[0]["args"]["id"] for n, v in ev.items()}
    assert ev["root"][0]["args"] == {"id": ids["root"], "parent": None, "wires": 2}
    assert ev["a"][0]["args"]["parent"] == ids["root"] == root.id
    assert ev["a.b"][0]["args"]["parent"] == ids["a"] == a.id
    assert ev["tick"][0]["args"]["parent"] == ids["root"]
    assert ev["child"][0]["args"]["parent"] == ids["tick"]
    assert ev["a"][0]["args"]["n"] == 5.0 and ev["a.b"][0]["args"]["m"] == 1.0
    assert ev["a"][0]["args"]["device_ms"] == pytest.approx(ev["a"][0]["dur"] / 1e3)
    assert ev["tick"][0]["args"]["gap_ms"] >= 2.0
    # children lie inside their parents on the recorder's clock
    for child, parent in (("a", "root"), ("a.b", "a"), ("child", "tick")):
        c, p = ev[child][0], ev[parent][0]
        assert p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"]
    counters = {e["name"]: e["args"]["value"] for e in tr.events if e["ph"] == "C"}
    assert counters == {"n": 6.0, "m": 1.0}
    snap = {m["name"]: m for m in reg.snapshot()["metrics"]}
    assert snap["n"]["value"] == 6 and snap["m"]["value"] == 1
    assert validate_trace(tr.to_json()) == []


class _FakeEvent:
    """A CUDA event on the CPU: ``record`` stamps the host clock."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def test_resolve_fills_device_times():
    tr = TraceRecorder()
    cuda = torch.device("cuda")
    with mock.patch.object(tl.torch.cuda, "Event", _FakeEvent), \
            mock.patch.object(tl.torch.cuda, "current_stream", lambda d=None: None):
        with tl.span(tr, "step", device=cuda):
            time.sleep(0.001)
        tick = tl.span(tr, "tick").begin()
        start = tl.mark(tr, cuda)
        time.sleep(0.001)
        tick.interval("gap_ms", start, tl.mark(tr, cuda))
        tick.end()
    ev = _by_name(tr)
    assert _FakeEvent.made == 4
    assert "device_ms" not in ev["step"][0]["args"] and "gap_ms" not in ev["tick"][0]["args"]
    tl.resolve(tr)
    assert 1.0 <= ev["step"][0]["args"]["device_ms"] <= ev["step"][0]["dur"] / 1e3
    assert ev["tick"][0]["args"]["gap_ms"] >= 1.0
    tl.resolve(tr)  # nothing left to read
    assert tl._state(tr).intervals == []


def test_anchor_maps_a_span_onto_the_epoch_clock():
    tr = TraceRecorder()
    obj = tr.to_json()
    assert obj["otherData"]["clock_anchor"] == {"perf_counter_ns": tr.anchor[0],
                                                "unix_ns": tr.anchor[1]}
    for _ in range(20):
        t0 = time.time_ns()
        with tl.span(tr, "x"):
            time.sleep(0.0002)
        t1 = time.time_ns()
        e = tr.events[-1]
        lo, hi = tl.epoch_ns(tr, e["ts"]), tl.epoch_ns(tr, e["ts"] + e["dur"])
        assert t0 - 5_000 <= lo <= hi <= t1 + 5_000, (t0, lo, hi, t1)


# ---------------------------------------------------------------------------
# the batched plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x22b"])
def test_untraced_serve_does_no_timeline_work(models, arch):
    """Under the profiler, with no recorder: no record_function, no CUDA
    event, no timeline state, no clock read, so no copy back either."""
    cfg, params, wires = models[arch]
    want = tserve.serve_requests(params, cfg, wires, **_KW)

    def refused(*a, **k):
        raise AssertionError("timeline work without a recorder")

    from torch.profiler import ProfilerActivity, profile

    with mock.patch.object(tl, "_state", refused), \
            mock.patch.object(tl.time, "perf_counter_ns", refused), \
            mock.patch.object(tl.torch.cuda, "Event", refused), \
            mock.patch.object(tl.torch.profiler, "record_function", refused), \
            mock.patch.object(tl, "_Span", refused), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd._profiler_enabled()
        got = tserve.serve_requests(params, cfg, wires, **_KW)
    assert got == want
    assert not [e for e in prof.events() if e.name.startswith("hgum.")]


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x22b"])
def test_traced_serve_same_bytes_and_spans(models, arch):
    cfg, params, wires = models[arch]
    want = tserve.serve_requests(params, cfg, wires, **_KW)
    tr, reg = TraceRecorder(), MetricsRegistry()
    assert tserve.serve_requests(params, cfg, wires, trace=tr, metrics=reg, **_KW) == want
    ev = _by_name(tr)
    ffn = "model.moe" if cfg.moe_experts else "model.ffn"
    for name in ("serve.call", "serve.des", "serve.ser", "batcher.tick", "batcher.prefill",
                 "batcher.decode", "batcher.sync", "batcher.emit", "model.attention", ffn,
                 "model.head", "model.argmax"):
        assert name in ev, name
    (call,) = ev["serve.call"]
    ids = {e["args"]["id"]: e for v in ev.values() for e in v}
    ticks = ev["batcher.tick"]
    steps = reg.snapshot()["metrics"]
    n_steps = next(m["value"] for m in steps if m["name"] == "batcher.steps")
    assert len(ticks) == len(ev["batcher.sync"]) == len(ev["batcher.emit"])
    assert len(ev["batcher.decode"]) == n_steps
    # 6 sequences on 4 slots: two admits
    assert [e["args"]["rows"] for e in ev["batcher.prefill"]] == [4, 2]
    for name in ("serve.des", "serve.ser", "batcher.tick"):
        assert all(e["args"]["parent"] == call["args"]["id"] for e in ev[name])
    for name in ("batcher.prefill", "batcher.decode", "batcher.sync", "batcher.emit"):
        assert all(ids[e["args"]["parent"]]["name"] == "batcher.tick" for e in ev[name])
    for name in ("model.attention", ffn, "model.head", "model.argmax"):
        assert {ids[e["args"]["parent"]]["name"] for e in ev[name]} == {
            "batcher.prefill", "batcher.decode"}
    assert all(e["args"]["device_ms"] > 0 for e in ev["batcher.prefill"] + ev["batcher.decode"])
    # every tick but the first has its gap
    assert "gap_ms" not in ticks[0]["args"]
    assert all(e["args"]["gap_ms"] > 0 for e in ticks[1:])
    # the spans of a call, in order and disjoint: DES, the ticks, SER
    order = sorted([ev["serve.des"][0], *ticks, ev["serve.ser"][0]], key=lambda e: e["ts"])
    assert order[0]["name"] == "serve.des" and order[-1]["name"] == "serve.ser"
    for a, b in zip(order, order[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    assert sum(e["dur"] for e in order) <= call["dur"]
    assert validate_trace(json.loads(json.dumps(tr.to_json()))) == []


def test_moe_counters_equal_the_drop_share():
    cfg = dataclasses.replace(smoke_config(get_config("mixtral-8x22b")), n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    p = params.layers[0].moe
    x = torch.randn(3, 40, cfg.d_model, generator=torch.Generator().manual_seed(2))
    for kw in (dict(capacity=8), dict(capacity=8, token_group=32)):
        tr = TraceRecorder()
        with torch.no_grad(), tl.span(tr, "layer") as s:
            _, aux = tffn.moe_ffn(p, x, cfg, **kw)
        tl.resolve(tr)
        routed, dropped = s.args["moe.routed"], s.args["moe.dropped"]
        assert routed == 3 * 40 * cfg.moe_topk + (
            (-(3 * 40) % 32) * cfg.moe_topk if "token_group" in kw else 0)
        assert dropped > 0
        assert dropped / routed == pytest.approx(float(aux["moe_dropped"]), rel=1e-6)
    # outside a span nothing is counted and the layer's answer is the same
    y0, _ = tffn.moe_ffn(p, x, cfg, capacity=8)
    tr = TraceRecorder()
    with tl.span(tr, "layer"):
        y1, _ = tffn.moe_ffn(p, x, cfg, capacity=8)
    assert torch.equal(y0, y1)


def test_traced_serve_counts_moe_drops(models):
    cfg, params, wires = models["mixtral-8x22b"]
    tr, reg = TraceRecorder(), MetricsRegistry()
    tserve.serve_requests(params, cfg, wires, trace=tr, metrics=reg, **_KW)
    moe = _by_name(tr)["model.moe"]
    routed = sum(e["args"]["moe.routed"] for e in moe)
    dropped = sum(e["args"]["moe.dropped"] for e in moe)
    assert routed > 0
    snap = {m["name"]: m["value"] for m in reg.snapshot()["metrics"]}
    assert snap["moe.routed"] == routed and snap["moe.dropped"] == dropped
    totals = {e["name"]: e["args"]["value"] for e in tr.events if e["ph"] == "C"}
    assert totals == {"moe.routed": routed, "moe.dropped": dropped}


def test_profiler_ranges_lie_inside_their_spans(models):
    cfg, params, wires = models["yi-6b"]
    from torch.profiler import ProfilerActivity, profile

    tr = TraceRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tserve.serve_requests(params, cfg, wires, trace=tr, **_KW)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("hgum."):
            ranges.setdefault(e.name()[len("hgum."):], []).append((e.start_ns(), e.end_ns()))
    spans = _by_name(tr)
    assert Counter({k: len(v) for k, v in ranges.items()}) == Counter(
        {k: len(v) for k, v in spans.items()})
    slack = 50_000  # ns: two clocks read back to back, and kineto's own conversion
    for name, evs in spans.items():
        for (a, b), e in zip(sorted(ranges[name]), sorted(evs, key=lambda e: e["ts"])):
            lo, hi = tl.epoch_ns(tr, e["ts"]), tl.epoch_ns(tr, e["ts"] + e["dur"])
            assert lo - slack <= a <= b <= hi + slack, (name, a - lo, hi - b)


def test_streaming_batchers_trace_their_ticks(models):
    cfg, params, wires = models["yi-6b"]
    want = tserve.serve_requests(params, cfg, wires, **_KW)
    tr = TraceRecorder()
    got = tserve.serve_requests_streaming(params, cfg, wires, n_shards=2, trace=tr,
                                          spans=SpanTracker(tr), **_KW)
    assert got == want
    ev = _by_name(tr)
    assert {"batcher.tick", "batcher.decode", "batcher.prefill", "serve.tick"} <= set(ev)
    assert "serve.des" not in ev and "serve.call" not in ev
    assert all("device_ms" in e["args"] for e in ev["batcher.decode"])


def test_serve_cli_batched_writes_spans(tmp_path, capsys):
    paths = {k: str(tmp_path / f"{k}.json") for k in ("m", "t")}
    tserve.main(["--arch", "mixtral-8x22b", "--smoke", "--device", "cpu", "--n-requests", "3",
                 "--n-prompts", "2", "--max-new", "3", "--pad-to", "8", "--slots", "2",
                 "--metrics-json", paths["m"], "--trace-out", paths["t"]])
    out = capsys.readouterr().out
    assert "batched(slots=2): 3 requests, 18 tokens" in out
    trace = json.loads(open(paths["t"]).read())
    assert validate_trace(trace) == []
    names = Counter(e["name"] for e in trace["traceEvents"])
    assert names["serve.des"] == names["serve.ser"] == names["serve.call"] == 1
    assert names["batcher.tick"] >= 3 and names["batcher.decode"] >= 2
    assert "unix_ns" in trace["otherData"]["clock_anchor"]
    snap = {m["name"]: m for m in json.loads(open(paths["m"]).read())["metrics"]}
    assert snap["batcher.admitted"]["value"] == 6
    assert snap["moe.routed"]["value"] > 0 and "moe.dropped" in snap
