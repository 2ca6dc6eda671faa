"""Port parity, telemetry plane: ``repro_torch.obs`` against the JAX package.

The port carries the reference's trace recorder, spans, reports, SLO
evaluator and ``python -m`` CLI over by copy; this file holds them to the
reference on the same inputs: the same public names and signatures, the
same trace events (host timestamps aside), the same rendered reports,
diffs and attribution tables, the same SLO verdicts and burn rates, and
the same CLI output and exit codes on the same artifacts, except the
provenance keys.  ``environment_meta`` names torch, CUDA and the device in
place of the JAX backend, and a port snapshot validates under both
packages' ``validate_snapshot``.  The serve CLI's four telemetry flags
write artifacts both packages read, and an SLO violation exits 1, as the
reference's does.
"""
import dataclasses
import inspect
import json

import pytest

jax = pytest.importorskip("jax")

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.obs import __main__ as jmain
from repro.obs import report as jreport
from repro.obs import slo as jslo
from repro.obs import spans as jspans
from repro.obs import trace as jtrace
from repro_torch.launch import serve as tserve
from repro_torch.obs import __main__ as tmain
from repro_torch.obs import report as treport
from repro_torch.obs import slo as tslo
from repro_torch.obs import spans as tspans
from repro_torch.obs import trace as ttrace
import torch_parity  # noqa: F401 (process setup: a share of the cores, TF32 off)


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):  # constants, tuples, dicts
        return None


@pytest.mark.parametrize("ref,port", [
    (jobs, tobs), (jtrace, ttrace), (jspans, tspans), (jreport, treport), (jslo, tslo),
    (jmain, tmain),
], ids=["obs", "trace", "spans", "report", "slo", "__main__"])
def test_exports_and_signatures_match(ref, port):
    """``__all__`` (where the module has one) and every public function and
    class signature, methods included, equal the reference's."""
    assert getattr(port, "__all__", None) == getattr(ref, "__all__", None)
    names = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items()
        if not n.startswith("_") and callable(v) and getattr(v, "__module__", "") == ref.__name__]
    assert names
    for n in names:
        r, p = getattr(ref, n), getattr(port, n)
        assert _signature(p) == _signature(r), n
        if inspect.isclass(r):
            for m, rv in vars(r).items():
                if callable(rv) and not m.startswith("__"):
                    assert _signature(getattr(p, m)) == _signature(rv), f"{n}.{m}"


# ---------------------------------------------------------------------------
# trace recorder
# ---------------------------------------------------------------------------


def _drive_trace(pkg):
    tr = pkg.TraceRecorder()
    tr.name_track(0, "fabric", tid=1, thread="ticks")
    tr.name_track(0, "fabric", tid=1, thread="ticks")  # idempotent
    with tr.span("tick", cat="fabric", args={"frames": 4}):
        tr.instant("chunk.arrive", pid=1, args={"stream": 2})
    tr.counter("inflight", {"frames": 3})
    tr.complete("serve.tick", 10.0, -1.0, cat="serve")
    return tr


def test_trace_events_match_reference(tmp_path):
    def untimed(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]

    t, j = _drive_trace(tobs), _drive_trace(jobs)
    assert untimed(t.to_json()["traceEvents"]) == untimed(j.to_json()["traceEvents"])
    obj = t.to_json()
    assert obj["displayTimeUnit"] == "ms" and tobs.validate_trace(obj) == []
    assert [e["dur"] for e in obj["traceEvents"] if e["ph"] == "X"][-1] == 0.0
    path = tmp_path / "t.json"
    t.save(path)
    assert jobs.validate_trace(json.loads(path.read_text())) == []
    for bad in ({"nope": 1}, 3, [1, {"ph": "X", "name": "x"}], [{"name": "y", "ph": "?"}],
                {"traceEvents": [{"name": "c", "ph": "C", "ts": 0}]}):
        assert tobs.validate_trace(bad) == jobs.validate_trace(bad) != []


def test_span_tracker_matches_reference():
    """The tracker's export, flow events and anomalies, and the tick
    breakdown, on the same calls (host clock fixed)."""
    def drive(pkg):
        tr = pkg.TraceRecorder()
        sp = pkg.SpanTracker(tr, clock=lambda: 5.0)
        sp.set_tick(0)
        rid = sp.start("request", cls=1)
        sp.event(rid, "serve.ingress")
        sp.add_component(rid, "fabric.transit", 3)
        sp.set_tick(2)
        sp.event(rid, "batcher.admit", slot=1)
        sp.set_tick(4)
        sp.event(rid, "serve.first_token")
        sp.degrade(rid, "crc,seq-gap", src=1)
        sp.finish(rid)
        rid2 = sp.start("request")
        sp.set_tick(7)
        sp.event(rid2, "stream.first_flush")
        sp.event(999, "batcher.admit")
        sp.degrade(999, "crc")
        sp.add_component(999, "fabric.stall", 1)
        sp.finish(999)
        return sp, [{k: v for k, v in e.items() if k != "ts"} for e in tr.events]

    (t, t_ev), (j, j_ev) = drive(tobs), drive(jobs)
    assert t.export() == j.export() and t_ev == j_ev
    assert [tobs.tick_breakdown(s) for s in t.requests()] == \
        [jobs.tick_breakdown(s) for s in j.requests()]
    assert tobs.tick_breakdown(t.get(1)) == {
        "admit_wait": 2, "batcher.admit->serve.first_token": 2, "ttft_ticks": 4}


# ---------------------------------------------------------------------------
# snapshots, provenance, reports
# ---------------------------------------------------------------------------


def _registry(pkg, scale=1.0):
    m = pkg.MetricsRegistry()
    m.counter("fabric.frames.delivered").add(int(40 * scale))
    m.counter("fabric.arq.retransmits").add(int(3 * scale))
    m.counter("serve.tokens", shard=1).add(7)
    m.gauge("serve.tokens_per_s").set(50.0 * scale)
    m.gauge("fabric.load_drift.entries").set(0 if scale == 1.0 else 2)
    for v in (0.1, 0.2, 0.3, 0.4 * scale):
        m.series("serve.ttft_s.series").append(v)
        m.histogram("serve.ttft_s", base=0.001).observe(v)
    for cls, steps in ((1, (1, 3, 9)), (2, (2, 2, 17))):
        for s in steps:
            m.histogram("fabric.arrive.step", cls=cls).observe(s * scale)
    return m


def test_environment_meta_names_torch_and_the_device():
    meta = tobs.environment_meta()
    assert "jax_version" not in meta
    assert meta["schema_version"] == jobs.environment_meta()["schema_version"] == \
        tobs.SNAPSHOT_SCHEMA
    import torch

    assert meta["torch_version"] == torch.__version__
    assert meta["cuda_version"] == torch.version.cuda
    assert (meta["backend"], meta["platform"], meta["device_kind"], meta["n_devices"]) == \
        ("cpu", "cpu", "cpu", 1)
    assert set(meta) == {"schema_version", "timestamp", "git_sha", "torch_version",
                         "cuda_version", "backend", "platform", "device_kind", "n_devices"}


def test_port_snapshot_validates_in_both_packages():
    snap = json.loads(tobs.render_json(_registry(tobs).snapshot()))
    assert "meta" in snap and "jax_version" not in snap["meta"]
    assert tobs.validate_snapshot(snap) == jobs.validate_snapshot(snap) == []
    ref = _registry(jobs).snapshot()
    assert {k: v for k, v in snap.items() if k != "meta"} == ref
    assert tobs.render_text(snap) == jobs.render_text(snap)
    broken = dict(snap, metrics=[{"name": "x", "type": "nope"}])
    assert tobs.validate_snapshot(broken) == jobs.validate_snapshot(broken) != []
    assert tobs.render_text(broken) == jobs.render_text(broken)


def test_reports_match_reference():
    a, b = _registry(tobs).snapshot(), _registry(tobs, scale=2.0).snapshot()
    b["metrics"].append({"name": "only.b", "type": "gauge", "labels": {}, "value": 1})
    for x, y in ((a, b), (b, a), (a, a)):
        d = tobs.diff_snapshots(x, y)
        assert d == jobs.diff_snapshots(x, y)
        assert tobs.render_diff(d) == jobs.render_diff(d)
    assert tobs.render_json(a, meta=False, indent=1) == jobs.render_json(a, meta=False, indent=1)
    sp = tobs.SpanTracker(clock=lambda: 0.0)
    for i, cls in enumerate((1, 2, None)):
        sp.set_tick(0)
        rid = sp.start("request", **({} if cls is None else {"cls": cls}))
        sp.event(rid, "serve.ingress")
        sp.add_component(rid, "fabric.queue_wait", i)
        sp.add_component(rid, "fabric.transit", 2 + i)
        sp.set_tick(1 + i)
        sp.event(rid, "batcher.admit")
        sp.set_tick(3 + 2 * i)
        sp.event(rid, "serve.first_token")
        if i == 1:
            sp.degrade(rid, "crc")
        if i != 2:
            sp.finish(rid)
    sp.anomaly("fabric.deliver.unmatched", src=1, dst=0)
    export = sp.export()
    assert tobs.attribution_rows(export) == jobs.attribution_rows(export)
    assert tobs.render_attribution(export) == jobs.render_attribution(export)
    empty = {"requests": []}
    assert tobs.render_attribution(empty) == jobs.render_attribution(empty)


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

_SPECS = [
    "ttft_p95_s=0.5,tokens_per_s_min=10,drift_free",
    "ttft_p95_s=0.2,ttft_p99_s=0.1,ttft_mean_s=1",
    {"arrive_p95_steps": 12, "max_retransmit_ratio": 0.01},
    {"arrive_p95_steps": 8, "max_retransmit_ratio": 0.5, "drift_free": False},
    {"max:fabric.frames.delivered": 100, "min:serve.tokens{shard=1}": 9},
    {"max:absent.metric": 1, "not_a_thing": 1},
    "tokens_per_s_min=1000",
]


@pytest.mark.parametrize("spec", _SPECS, ids=range(len(_SPECS)))
@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("window", [None, 2])
def test_evaluate_slo_matches_reference(spec, scale, window):
    snap = _registry(tobs, scale).snapshot()
    got = tobs.evaluate_slo(spec, snapshot=snap, window=window)
    want = jobs.evaluate_slo(spec, snapshot=snap, window=window)
    assert [dataclasses.asdict(r) for r in got.results] == \
        [dataclasses.asdict(r) for r in want.results]
    assert got.ok == want.ok and got.render_text() == want.render_text()


def test_evaluate_slo_values_and_missing_signals_match():
    for spec, values in (("min:fabric.smoke_frames_per_s=10", {"fabric.smoke_frames_per_s": 100.0}),
                         ("max:x=1", {"x": "text"}),
                         ("ttft_p95_s=1,arrive_p95_steps=1,drift_free,max_retransmit_ratio=1",
                          None)):
        got = tobs.evaluate_slo(spec, values=values)
        want = jobs.evaluate_slo(spec, values=values)
        assert [dataclasses.asdict(r) for r in got.results] == \
            [dataclasses.asdict(r) for r in want.results]
    hist_only = {"metrics": [r for r in _registry(tobs).snapshot()["metrics"]
                             if r["name"] != "serve.ttft_s.series"]}
    for spec in ("ttft_p95_s=0.3", "ttft_mean_s=0.3"):
        assert tobs.evaluate_slo(spec, snapshot=hist_only).render_text() == \
            jobs.evaluate_slo(spec, snapshot=hist_only).render_text()


def test_parse_slo_matches_reference(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text('{"ttft_p95_s": 0.25, "drift_free": true}')
    for spec in ("a=1.5,drift_free", "k=text, m=2,", {"k": 2}, str(path)):
        assert tobs.parse_slo(spec) == jobs.parse_slo(spec)
    not_obj = tmp_path / "list.json"
    not_obj.write_text("[1]")
    for bad in ("  ", ",", str(not_obj)):
        with pytest.raises(ValueError) as want:
            jobs.parse_slo(bad)
        with pytest.raises(ValueError) as got:
            tobs.parse_slo(bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _run(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:  # argparse errors
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def artifacts(tmp_path):
    a = tobs.MetricsRegistry()
    a.counter("x").add(1)
    a.gauge("fabric.load_drift.entries").set(0)
    snap = a.snapshot()
    snap["meta"] = tobs.environment_meta()
    files = {"a": tmp_path / "a.json", "b": tmp_path / "b.json", "t": tmp_path / "t.json",
             "bad": tmp_path / "bad.json", "spans": tmp_path / "spans.json",
             "badtrace": tmp_path / "bt.json"}
    files["a"].write_text(json.dumps(snap))
    b = tobs.MetricsRegistry()
    b.counter("x").add(5)
    files["b"].write_text(b.to_json())
    _drive_trace(tobs).save(files["t"])
    files["bad"].write_text('{"what": 1}')
    files["badtrace"].write_text('[{"name": "x", "ph": "X", "ts": 1}]')
    sp = tobs.SpanTracker(clock=lambda: 1.0)
    sp.set_tick(0)
    rid = sp.start("request", cls=1)
    sp.event(rid, "serve.ingress")
    sp.add_component(rid, "fabric.transit", 3)
    sp.set_tick(2)
    sp.event(rid, "serve.first_token")
    sp.finish(rid)
    files["spans"].write_text(json.dumps(sp.export()))
    return {k: str(v) for k, v in files.items()}


_ARGVS = [
    ["{a}"], ["{a}", "--validate"], ["{b}"], ["{t}"], ["{t}", "--validate"],
    ["{t}", "--kind", "metrics"], ["{bad}", "--validate"], ["{badtrace}"], ["{missing}"],
    ["diff", "{a}", "{b}"], ["diff", "{a}", "{b}", "--json"],
    ["diff", "{a}", "{b}", "--fail-on-change"], ["diff", "{a}", "{a}", "--fail-on-change"],
    ["slo", "max:x=10", "--metrics", "{a}"], ["slo", "max:x=0.5", "--metrics", "{b}"],
    ["slo", "drift_free,max:x=2", "--metrics", "{a}", "--window", "1"],
    ["attribution", "{spans}"], ["attribution", "{spans}", "--json"],
]


@pytest.mark.parametrize("argv", _ARGVS, ids=[" ".join(a) for a in _ARGVS])
def test_obs_cli_matches_reference(argv, artifacts, tmp_path, capsys):
    """The same output and exit code as ``python -m repro.obs`` on the same
    artifacts; only the ``meta:`` provenance line differs."""
    argv = [a.format(missing=str(tmp_path / "missing.json"), **artifacts) for a in argv]
    got = _run(tmain.main, argv, capsys)
    want = _run(jmain.main, argv, capsys)

    def no_meta(text):
        return [ln for ln in text.splitlines() if not ln.startswith("meta: ")]

    assert got[0] == want[0]
    assert no_meta(got[1]) == no_meta(want[1])
    assert got[2].replace("repro_torch.obs", "repro.obs") == want[2]
    if argv == [artifacts["a"]]:
        meta = [ln for ln in got[1].splitlines() if ln.startswith("meta: ")]
        assert meta and "backend=cpu" in meta[0] and "torch_version=" in meta[0]
        assert "jax_version" not in meta[0]


# ---------------------------------------------------------------------------
# the serve CLI's telemetry flags
# ---------------------------------------------------------------------------


def test_serve_cli_telemetry_flags(tmp_path, capsys):
    """``--metrics-json``, ``--trace-out``, ``--attribution-json`` and a
    violated ``--slo`` on the CPU streaming serve: the artifacts are
    written and valid under both packages' readers, and the run exits 1
    after printing the SLO report."""
    paths = {k: str(tmp_path / f"{k}.json") for k in ("m", "t", "s")}
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--n-requests", "3",
                     "--n-prompts", "2", "--max-new", "3", "--pad-to", "8", "--slots", "2",
                     "--streaming", "--n-shards", "3", "--metrics-json", paths["m"],
                     "--trace-out", paths["t"], "--attribution-json", paths["s"],
                     "--slo", "ttft_p95_s=0.000000001,drift_free"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "streaming(slots=2): 3 requests, 18 tokens" in out
    assert "[FAIL] ttft_p95_s" in out and "[PASS] drift_free" in out
    assert "objective(s) VIOLATED" in out
    snap = json.loads(open(paths["m"]).read())
    assert tobs.validate_snapshot(snap) == jobs.validate_snapshot(snap) == []
    assert snap["meta"]["backend"] == "cpu" and "jax_version" not in snap["meta"]
    trace = json.loads(open(paths["t"]).read())
    assert tobs.validate_trace(trace) == jobs.validate_trace(trace) == []
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"serve.tick", "fabric.tick", "stream.chunk", "request"} <= names
    export = json.loads(open(paths["s"]).read())
    assert len(export["requests"]) == 3 and all(r["done"] for r in export["requests"])
    assert tobs.render_attribution(export) == jobs.render_attribution(export)
    for main in (tmain.main, jmain.main):
        assert main([paths["m"], "--validate"]) == 0
        assert main([paths["t"], "--validate"]) == 0
        assert main(["attribution", paths["s"]]) == 0
    capsys.readouterr()
    tserve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--n-requests", "2",
                 "--n-prompts", "1", "--max-new", "2", "--pad-to", "8", "--slots", "2",
                 "--sharded", "--n-shards", "2", "--metrics-json", paths["m"],
                 "--slo", "drift_free,max:fabric.crc.failures=0"])
    out = capsys.readouterr().out
    assert "slo: all objectives met" in out
