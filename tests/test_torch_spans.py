"""Port parity, request spans and the trace: ``repro_torch.obs.spans`` and
``obs.trace`` wired through the port's fabric and streaming serve, against
the JAX package.

* **Fabric spans.**  The same sends, each tagged with a request id, go
  through the reference's fabric (8 fake CPU devices from
  ``tests/conftest.py``) and the port's (ranks as a tensor axis), each with
  its own package's ``SpanTracker``.  The span exports (events, ticks,
  flight-recorder components, degradation reasons, anomalies) must be
  identical once the host timestamps are removed: on both tick engines,
  under a corrupting seeded ``FaultPlan`` (with and without ARQ, aborts
  included), and under ``tx_hook`` corruption and seq rewrites.
* **Serve spans.**  ``serve_requests_streaming`` with ``trace``, ``spans``,
  ``metrics`` and ``analyze=True`` gives the same bytes as without them,
  and its span export equals the reference's, timestamps removed; the
  trace validates, carries one ``serve.tick`` per compute tick and a
  ``fabric.tick`` per fabric tick, renders each request as one flow arc,
  and the tick breakdown telescopes to TTFT.  No ``fabric.recompile``
  instant: eager torch compiles nothing per tick shape.

Runs at the reference's smoke sizes: yi-6b cut to 2 layers, ``max_new=4``,
``pad_to=8``, ``n_shards=2``, the reference's parameters carried over.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.fabric import Fabric as JFabric
from repro.fabric import FabricConfig as JConfig
from repro.fabric import FaultPlan as JFaultPlan
from repro.launch import serve as jserve
from repro.models import init_params as j_init_params
from repro.obs import SpanTracker as JSpanTracker
from repro.obs import TraceRecorder as JTraceRecorder
from repro_torch.configs import get_config, smoke_config
from repro_torch.fabric import Fabric, FabricConfig, FaultPlan
from repro_torch.fabric.frames import HDR_ROUTE
from repro_torch.launch import serve as tserve
from repro_torch.models import params_from_jax
from repro_torch.obs import (
    MetricsRegistry,
    SpanTracker,
    TraceRecorder,
    tick_breakdown,
    validate_trace,
)

#: host-clock fields of a span export (everything else must match)
_CLOCK_KEYS = ("ts_us", "ttft_s")


def _untimed(obj):
    """A span export with its host-clock values removed."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _CLOCK_KEYS}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# fabric-level spans
# ---------------------------------------------------------------------------


def _fabric(port: bool, n: int, kw: dict, faults=None):
    if port:
        fab = Fabric(n_ranks=n, config=FabricConfig(**kw), device="cpu")
        fab.faults = None if faults is None else FaultPlan(**faults)
        fab.spans = SpanTracker()
    else:
        fab = JFabric(n_ranks=n, config=JConfig(**kw))
        fab.faults = None if faults is None else JFaultPlan(**faults)
        fab.spans = JSpanTracker()
    return fab


def _corrupt_second_frame(tx, tx_valid):
    tx = np.array(tx)
    tx[1, 1, 5] ^= 0xFF  # a payload phit of rank 1's second frame
    return tx


def _rewrite_seq(tx, tx_valid):
    tx = np.array(tx)
    w = int(tx[1, 1, HDR_ROUTE])
    tx[1, 1, HDR_ROUTE] = (w & ~0xFFFF) | ((w + 5) & 0xFFFF)
    return tx


_ARQ = dict(arq=True, retransmit_timeout=2, max_retries=1)
_FABRIC_CASES = {
    # name: (ranks, config, FaultPlan, tx_hook, idle ticks after the sends)
    "fused": (8, dict(frame_phits=2, credits=2, qos_weights=(2, 1)), None, None, 0),
    "programs": (8, dict(frame_phits=2, credits=2, qos_weights=(2, 1), fused=False),
                 None, None, 0),
    "fused-corrupt": (4, dict(frame_phits=2, credits=4),
                      dict(seed=3, corrupt=0.2, drop=0.1), None, 2),
    "programs-corrupt": (4, dict(frame_phits=2, credits=4, fused=False),
                         dict(seed=3, corrupt=0.2, drop=0.1), None, 2),
    "fused-arq-aborts": (4, dict(frame_phits=2, credits=4, **_ARQ),
                         dict(seed=5, drop=0.6, corrupt=0.2), None, 4),
    "programs-arq-aborts": (4, dict(frame_phits=2, credits=4, fused=False, **_ARQ),
                            dict(seed=5, drop=0.6, corrupt=0.2), None, 4),
    "tx-hook-crc": (4, dict(frame_phits=2, credits=4), None, _corrupt_second_frame, 0),
    "tx-hook-seq": (4, dict(frame_phits=2, credits=4), None, _rewrite_seq, 0),
}


def _fabric_spans(port: bool, case: str):
    """Every rank sends to every other rank, each message a request; the
    export, and every delivery's (dst, src, rid, ok)."""
    n, kw, faults, hook, idle = _FABRIC_CASES[case]
    fab = _fabric(port, n, kw, faults)
    fab.tx_hook = hook
    sp = fab.spans
    boxes = [fab.mailbox(r) for r in range(n)]
    for s in range(n):
        for d in range(n):
            if s != d:
                rid = sp.start("request", src=s, dst=d)
                boxes[s].send(d, bytes([s, d]) * (17 + 5 * s), list_level=1 + (s % 2),
                              request_id=rid)
    got = []
    for t in range(idle + 1):
        sp.set_tick(t)
        fab.exchange()
        for r in range(n):
            got += [(r, dv.src, dv.request_id, dv.ok) for dv in boxes[r].recv()]
    return sp.export(), got


@pytest.mark.parametrize("case", list(_FABRIC_CASES))
def test_fabric_span_exports_identical(case):
    t_export, t_got = _fabric_spans(True, case)
    j_export, j_got = _fabric_spans(False, case)
    assert t_got == j_got
    assert _untimed(t_export) == _untimed(j_export)
    reqs = t_export["requests"]
    deliver = [e for r in reqs for e in r["events"] if e["name"] == "fabric.deliver"]
    assert deliver, "no delivery was correlated"
    if case in ("fused", "programs"):
        assert all(ok for *_, ok in t_got) and len(deliver) == len(reqs)
        assert all({"fabric.queue_wait", "fabric.stall", "fabric.transit",
                    "fabric.defections"} <= set(r["components"]) for r in reqs)
    elif case.endswith("-corrupt") or case.startswith("tx-hook"):
        assert any(r["degraded"] for r in reqs), "the faults degraded no span"
    if case == "tx-hook-crc":
        assert any("crc" in r["reasons"] for r in reqs)
    if case == "tx-hook-seq":
        assert any("seq-gap" in r["reasons"] for r in reqs)
    if case.endswith("arq-aborts"):
        assert any(a["name"] == "fabric.arq.abort" for a in t_export["anomalies"])


def test_fabric_trace_tick_events():
    """One ``fabric.tick`` complete event per fabric tick, with the
    reference's args, and no ``fabric.recompile`` instant (the reference
    logs a jit bucket; eager torch compiles nothing)."""
    trace, jtrace = TraceRecorder(), JTraceRecorder()
    kw = dict(frame_phits=2, credits=2)
    fab = Fabric(n_ranks=4, config=FabricConfig(**kw), trace=trace, device="cpu")
    jfab = JFabric(n_ranks=4, config=JConfig(**kw), trace=jtrace)
    for f in (fab, jfab):
        for s in range(4):
            f.mailbox(s).send((s + 1) % 4, bytes(range(40)))
        f.exchange()
        f.mailbox(0).send(2, b"x")
        f.exchange_async()
        f.poll()

    def ticks(tr):
        return [(e["args"], e["cat"]) for e in tr.events if e["name"] == "fabric.tick"]

    assert ticks(trace) == ticks(jtrace) and len(ticks(trace)) == 2
    assert validate_trace(trace.to_json()) == []
    assert all(e["dur"] >= 0 for e in trace.events if e["name"] == "fabric.tick")
    assert not any(e["name"] == "fabric.recompile" for e in trace.events)
    assert any(e["name"] == "fabric.recompile" for e in jtrace.events)


# ---------------------------------------------------------------------------
# the streaming serve, traced
# ---------------------------------------------------------------------------

_KW = dict(max_new=4, pad_to=8, slots=4, n_shards=2)


@pytest.fixture(scope="module")
def serve_setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = dataclasses.replace(j_smoke_config(j_get_config("yi-6b")), n_layers=2)
    cfg = dataclasses.replace(smoke_config(get_config("yi-6b")), n_layers=2)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(1)
    wires = []
    for r in range(3):
        prompts = [list(map(int, rng.integers(2, cfg.vocab, int(rng.integers(8, 16)))))
                   for _ in range(int(rng.integers(1, 3)))]
        wires.append(tserve.encode_request(r, prompts))
    plain = tserve.serve_requests_streaming(tparams, cfg, wires, device="cpu", **_KW)
    jtrace = JTraceRecorder()
    jspans = JSpanTracker(jtrace)
    want = jserve.serve_requests_streaming(jparams, jcfg, wires, trace=jtrace, spans=jspans,
                                           **_KW)
    return cfg, tparams, wires, plain, want, jspans


def test_streaming_serve_spans_match_reference(serve_setup):
    """Trace, spans, metrics and analyze=True on: the same bytes as
    without them and as the reference, and the reference's span export,
    timestamps removed."""
    cfg, tparams, wires, plain, want, jspans = serve_setup
    trace, metrics = TraceRecorder(), MetricsRegistry()
    spans = SpanTracker(trace)
    fab = tserve.default_serve_fabric(2, device="cpu")
    got = tserve.serve_requests_streaming(tparams, cfg, wires, fabric=fab, trace=trace,
                                          spans=spans, metrics=metrics, analyze=True,
                                          device="cpu", **_KW)
    assert got == plain == want
    assert fab.analyze and fab.trace is trace and fab.spans is spans
    export = json.loads(json.dumps(spans.export()))
    assert _untimed(export) == _untimed(json.loads(json.dumps(jspans.export())))

    reqs = spans.requests()
    assert len(reqs) == len(wires) and not spans.anomalies
    for span in reqs:
        assert span.done and not span.degraded, span.rid
        bd = tick_breakdown(span)
        assert {"admit_wait", "ttft_ticks"} <= set(bd)
        assert sum(v for k, v in bd.items() if k != "ttft_ticks") == bd["ttft_ticks"]
        assert span.first_tick("serve.ingress") == 0
        assert span.first_tick("serve.first_token") == bd["ttft_ticks"]
        names = [e.name for e in span.events]
        for must in ("serve.ingress", "fabric.deliver", "batcher.admit",
                     "stream.first_flush", "serve.first_token", "batcher.evict",
                     "request.done"):
            assert must in names, (span.rid, must)

    obj = trace.to_json()
    assert validate_trace(obj) == []
    events = obj["traceEvents"]
    serve_ticks = [e for e in events if e["name"] == "serve.tick"]
    fabric_ticks = [e for e in events if e["name"] == "fabric.tick"]
    assert len(serve_ticks) >= 1 and len(fabric_ticks) == fab.exchanges
    assert sum(e["args"]["tokens_arrived"] for e in serve_ticks) <= \
        sum(len(o) for w in got for o in tserve.decode_response(w)[1])
    assert any(e["name"] == "stream.chunk" for e in events)
    assert not any(e["name"] == "fabric.recompile" for e in events)
    flows = {}
    for e in events:
        if e.get("cat") == "span" and e.get("ph") in "stf":
            flows.setdefault(e["id"], set()).add(e["ph"])
    assert set(flows) == {s.rid for s in reqs}
    assert all(phs == {"s", "t", "f"} for phs in flows.values())
    names = {m["name"] for m in metrics.snapshot()["metrics"]}
    assert {"serve.ttft_s", "serve.tokens_per_s", "fabric.load_drift.entries"} <= names


def test_streaming_serve_trace_auto_creates_spans(serve_setup):
    """A trace alone still traces requests: the serve makes a
    ``SpanTracker`` on it, as the reference does."""
    cfg, tparams, wires, plain, _, _ = serve_setup
    trace = TraceRecorder()
    got = tserve.serve_requests_streaming(tparams, cfg, wires, trace=trace, device="cpu",
                                          **_KW)
    assert got == plain
    assert any(e.get("ph") == "s" and e.get("cat") == "span" for e in trace.events)
    assert validate_trace(trace.to_json()) == []


def test_sharded_serve_traced_and_analyzed(serve_setup):
    """``serve_requests_sharded(analyze=True, trace=)`` answers with the
    batched plane's bytes and records one ``fabric.tick`` per tick."""
    cfg, tparams, wires, _, _, _ = serve_setup
    kw = dict(max_new=4, pad_to=8, slots=4)
    base = tserve.serve_requests(tparams, cfg, wires, device="cpu", **kw)
    trace = TraceRecorder()
    fab = tserve.default_serve_fabric(2, device="cpu")
    got = tserve.serve_requests_sharded(tparams, cfg, wires, fabric=fab, analyze=True,
                                        trace=trace, device="cpu", **kw)
    assert got == base and fab.analyze
    ticks = [e for e in trace.events if e["name"] == "fabric.tick"]
    assert len(ticks) == fab.exchanges >= 2
    assert validate_trace(trace.to_json()) == []
