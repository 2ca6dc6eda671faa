"""Port parity, static analyzer: ``repro_torch.analysis`` against the JAX package.

Every pass, over every shipped target and every seeded bad input of
``tests/test_analysis.py``, must give the reference's findings exactly:
the same rule id, severity, location, message and fix hint, in the same
order.  The public names and signatures of the package must be the
reference's, the ``python -m`` CLI must write the same report and JSON,
and the runtime hooks (``Fabric(analyze=True)``, ``_analyze_serve``) must
raise where and as the reference raises, before anything is dispatched.
The analyzer is host code in both packages, so nothing here needs a card.
"""
import inspect
import json

import pytest

jax = pytest.importorskip("jax")

import repro.analysis as jan
import repro_torch.analysis as tan
from repro.analysis import __main__ as jmain
from repro.analysis import config_passes as jcp
from repro.analysis import fabric_passes as jfp
from repro.analysis import schema_passes as jsp
from repro.analysis import targets as jtg
from repro.configs import get_config as j_get_config
from repro.core import idl as jidl
from repro.core.schema_tree import ROM_CAPACITY, STACK_CAPACITY
from repro.fabric import Fabric as JFabric
from repro.fabric import FabricConfig as JConfig
from repro.launch import serve as jserve
from repro_torch.analysis import __main__ as tmain
from repro_torch.analysis import config_passes as tcp
from repro_torch.analysis import fabric_passes as tfp
from repro_torch.analysis import schema_passes as tsp
from repro_torch.analysis import targets as ttg
from repro_torch.configs import get_config
from repro_torch.core import idl as tidl
from repro_torch.fabric import Fabric, FabricConfig
from repro_torch.launch import serve as tserve
import torch_parity  # noqa: F401 (process setup: a share of the cores, TF32 off)


def _rows(findings):
    """Everything a finding says, in order."""
    return [(f.rule, f.severity.name, f.location, f.message, f.hint) for f in findings]


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):  # constants, enums, dicts
        return None


# ---------------------------------------------------------------------------
# the package's surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref,port", [
    (jan, tan), (jsp, tsp), (jfp, tfp), (jcp, tcp), (jtg, ttg), (jmain, tmain),
], ids=["analysis", "schema_passes", "fabric_passes", "config_passes", "targets",
        "__main__"])
def test_exports_and_signatures_match(ref, port):
    """``__all__`` (where the module has one) and every public function or
    class signature, lazy names included, equal the reference's."""
    assert getattr(port, "__all__", None) == getattr(ref, "__all__", None)
    names = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items()
        if not n.startswith("_") and callable(v) and getattr(v, "__module__", "") == ref.__name__]
    assert names
    for n in names:
        assert _signature(getattr(port, n)) == _signature(getattr(ref, n)), n


# ---------------------------------------------------------------------------
# findings over every shipped target
# ---------------------------------------------------------------------------


def test_shipped_target_lists_match():
    assert [t[0] for t in ttg.schema_targets()] == [t[0] for t in jtg.schema_targets()]
    assert [t[0] for t in ttg.stream_targets()] == [t[0] for t in jtg.stream_targets()]
    assert ttg.fabric_targets() == jtg.fabric_targets()
    assert ttg.demand_targets() == jtg.demand_targets()
    assert [t[0] for t in ttg.model_config_targets()] == \
        [t[0] for t in jtg.model_config_targets()]
    assert ttg.total_targets() == jtg.total_targets() >= 40


def test_findings_identical_over_every_shipped_target():
    """Every pass over every target, the wire bounds and the static load
    matrices included, and the aggregated report of ``run_all``."""
    for (loc, s, c, caps), (jloc, js, jc, jcaps) in zip(ttg.schema_targets(),
                                                          jtg.schema_targets()):
        assert loc == jloc and caps == jcaps
        assert _rows(tsp.analyze_schema(s, client=c, caps=caps, location=loc)) == \
            _rows(jsp.analyze_schema(js, client=jc, caps=jcaps, location=loc))
        tb, jb = tsp.wire_bounds(s), jsp.wire_bounds(js)
        assert (tb.min_bytes, tb.max_bytes, tb.min_frames(16), tb.max_frames(16)) == \
            (jb.min_bytes, jb.max_bytes, jb.min_frames(16), jb.max_frames(16))
    for (loc, s), (_, js) in zip(ttg.stream_targets(), jtg.stream_targets()):
        assert _rows(tsp.analyze_stream_schema(s, location=loc)) == \
            _rows(jsp.analyze_stream_schema(js, location=loc))
    for loc, kw in ttg.fabric_targets():
        assert _rows(tfp.analyze_fabric_values(location=loc, **kw)) == \
            _rows(jfp.analyze_fabric_values(location=loc, **kw))
    for loc, sizes, kw, srcs, dsts, counts, levels in ttg.demand_targets():
        t_loads, t_fs = tfp.analyze_demand(sizes, FabricConfig(**kw), srcs, dsts, counts,
                                           levels=levels, location=loc)
        j_loads, j_fs = jfp.analyze_demand(sizes, JConfig(**kw), srcs, dsts, counts,
                                           levels=levels, location=loc)
        assert _rows(t_fs) == _rows(j_fs)
        assert [{k: (v.frames, v.max_hops) for k, v in g.items()} for g in t_loads] == \
            [{k: (v.frames, v.max_hops) for k, v in g.items()} for g in j_loads]
    for (loc, cfg), (_, jcfg) in zip(ttg.model_config_targets(), jtg.model_config_targets()):
        assert _rows(tcp.analyze_model_config(cfg, location=loc)) == \
            _rows(jcp.analyze_model_config(jcfg, location=loc))
    assert tmain.run_all().to_json() == jmain.run_all().to_json()


# ---------------------------------------------------------------------------
# the seeded-bad corpus of tests/test_analysis.py, through both packages
# ---------------------------------------------------------------------------


def _deep(depth):
    t = ["Bytes", 4]
    for _ in range(depth):
        t = ["List", t]
    return {"M": [["x", t]]}


def _schema_case(pkg, case):
    """The case's schema (and client) built with ``pkg``'s own IDL."""
    S, SRef, Client = pkg.Schema, pkg.StructRef, pkg.ClientSchema
    if case == "undefined":
        return S({"M": [("x", SRef("Ghost"))]}, top="M"), None
    if case == "recursive":
        return S({"M": [("x", SRef("M"))]}, top="M"), None
    if case == "empty":
        return S({"M": [("x", SRef("E"))], "E": []}, top="M"), None
    if case == "unreachable":
        return S.from_json({"M": [["x", ["Bytes", 4]]], "Dead": [["y", ["Bytes", 1]]]}), None
    if case == "stack-depth":
        return S.from_json(_deep(STACK_CAPACITY + 1)), None
    if case == "stack-depth-ok":
        return S.from_json(_deep(STACK_CAPACITY - 1)), None
    if case == "rom-capacity":
        return S.from_json({"M": [[f"f{i}", ["Bytes", 1]] for i in range(ROM_CAPACITY + 1)]}), None
    if case == "list-level":
        return S.from_json(_deep(300)), None
    if case == "client-tags":
        return S.from_json({"M": [["x", ["Bytes", 4]]]}), Client({"x": 1, "ghost": 1})
    raise KeyError(case)


_SCHEMA_CASES = ["undefined", "recursive", "empty", "unreachable", "stack-depth",
                 "stack-depth-ok", "rom-capacity", "list-level", "client-tags"]


@pytest.mark.parametrize("case", _SCHEMA_CASES)
def test_bad_schema_findings_identical(case):
    ts, tc = _schema_case(tidl, case)
    js, jc = _schema_case(jidl, case)
    want = _rows(jsp.analyze_schema(js, client=jc))
    assert _rows(tsp.analyze_schema(ts, client=tc)) == want
    assert want or case == "stack-depth-ok"  # the corpus really fires
    if case not in ("undefined", "recursive", "empty"):
        assert _rows(tsp.analyze_stream_schema(ts)) == _rows(jsp.analyze_stream_schema(js))


_STREAM_BAD = {
    "non-fixed-elem": {"M": [["s", ["Stream", ["List", ["Bytes", 4]]]]]},
    "wide-elem": {"M": [["s", ["Stream", ["Array", ["Bytes", 1 << 20]]]]]},
    "two-streams": {"M": [["s", ["Stream", ["Bytes", 4]]],
                          ["t", ["Stream", ["Struct", "P"]]]],
                    "P": [["a", ["Bytes", 2]], ["b", ["Bytes", 8]]]},
}


@pytest.mark.parametrize("case", list(_STREAM_BAD))
@pytest.mark.parametrize("bits", [None, (8, 8), (40, 30)], ids=["shipped", "narrow", "wide"])
def test_stream_schema_findings_identical(case, bits):
    """The stream rules (element size, meta budget, id width) over typed
    streams, at the shipped budgets and at too narrow and too wide ones."""
    kw = {} if bits is None else dict(id_bits=bits[0], step_bits=bits[1])
    try:
        js = jidl.Schema.from_json(_STREAM_BAD[case])
    except jidl.SchemaError as e:
        with pytest.raises(tidl.SchemaError, match=str(e)[:30]):
            tidl.Schema.from_json(_STREAM_BAD[case])
        return
    ts = tidl.Schema.from_json(_STREAM_BAD[case])
    assert _rows(tsp.analyze_stream_schema(ts, location=case, **kw)) == \
        _rows(jsp.analyze_stream_schema(js, location=case, **kw))


@pytest.mark.parametrize("caps", [
    {"lst": 8, "lst.elem": 4}, {"lst": 2 ** 32}, {"lst": 8, "lst.elem": 64},
], ids=["overflow", "count-width", "clean"])
def test_plan_caps_findings_identical(caps):
    j = {"M": [["lst", ["List", ["List", ["Bytes", 4]]]]]}
    assert _rows(tsp.analyze_plan_caps(tidl.Schema.from_json(j), caps)) == \
        _rows(jsp.analyze_plan_caps(jidl.Schema.from_json(j), caps))


@pytest.mark.parametrize("kw", [
    dict(credits=2, qos_weights=(1, 1, 1)),  # credit deadlock
    dict(credits=4, qos_weights=(8, 1, 1)),  # QoS quota floor
    dict(credits=2, defect_after=8, sizes=(8,)),  # defect bound
    dict(n_ranks=129), dict(n_ranks=128), dict(sizes=(16, 16)),  # max ranks
    dict(frame_phits=0, credits=0, routing="bogus"),
    dict(rx_frames=0),
    dict(arq=True, arq_level=1, qos_weights=(1, 1)),
    dict(arq=True, retransmit_timeout=0, max_retries=-1, arq_buffer=0),
    dict(arq=True, arq_skip_after=2, retransmit_timeout=4, suspect_after=1),
], ids=["credit-deadlock", "qos-floor", "defect-bound", "max-ranks", "128-ranks",
        "sizes-16x16", "positive", "rx-frames", "arq-level", "arq-values", "arq-timers"])
def test_fabric_value_findings_identical(kw):
    assert _rows(tfp.analyze_fabric_values(**kw)) == _rows(jfp.analyze_fabric_values(**kw))


@pytest.mark.parametrize("case", [
    ("rank-range", {}, [0], [9], [1], None),
    ("list-level", {}, [0], [1], [1], [300]),
    ("seq-window", {}, [0], [1], [1 << 16], None),
    ("rx-overflow", {"rx_frames": 2}, [0, 2], [1, 1], [2, 2], None),
    ("rx-clean", {"rx_frames": 2}, [0], [1], [2], None),
], ids=lambda c: c[0])
def test_demand_findings_identical(case):
    _, extra, srcs, dsts, counts, levels = case
    kw = dict(frame_phits=16, credits=4, **extra)
    t_loads, t_fs = tfp.analyze_demand((8,), FabricConfig(**kw), srcs, dsts, counts,
                                       levels=levels)
    j_loads, j_fs = jfp.analyze_demand((8,), JConfig(**kw), srcs, dsts, counts,
                                       levels=levels)
    assert _rows(t_fs) == _rows(j_fs)
    assert len(t_loads) == len(j_loads)


@pytest.mark.parametrize("name", ["yi-6b", "mixtral-8x22b", "gemma2-27b"])
@pytest.mark.parametrize("bad", [
    dict(moe_experts=4, moe_topk=8), dict(n_kv=3), dict(n_kv=0),
    dict(head_dim=None, d_model=1000, n_heads=3), dict(layer_pattern="zz"),
], ids=["moe-topk", "head-grouping", "no-kv", "head-dim", "layer-pattern"])
def test_model_config_findings_identical(name, bad):
    import dataclasses

    fields = {f.name for f in dataclasses.fields(get_config(name))}
    kw = {k: v for k, v in bad.items() if k in fields}
    if not kw:
        pytest.skip(f"{name}'s config has none of {sorted(bad)}")
    tcfg = dataclasses.replace(get_config(name), **kw)
    jcfg = dataclasses.replace(j_get_config(name), **kw)
    assert _rows(tcp.analyze_model_config(tcfg)) == _rows(jcp.analyze_model_config(jcfg))


@pytest.mark.parametrize("grid", [(8,), (4, 2)])
def test_live_fabric_findings_identical(grid):
    """``analyze_fabric`` reads ``config``, ``router.sizes`` and ``n_ranks``
    of the rank-axis fabric as of the reference's mesh fabric."""
    kw = dict(frame_phits=2, credits=4, qos_weights=(8, 1, 1))
    if len(grid) == 1:
        t, j = Fabric(n_ranks=8, config=FabricConfig(**kw), device="cpu"), \
            JFabric(n_ranks=8, config=JConfig(**kw))
    else:
        t = Fabric(grid=grid, axis_names=("fx", "fy"), config=FabricConfig(**kw), device="cpu")
        j = JFabric(mesh=jax.make_mesh(grid, ("fx", "fy")), config=JConfig(**kw))
    assert (t.router.sizes, t.n_ranks) == (tuple(j.router.sizes), j.n_ranks)
    rows = _rows(tfp.analyze_fabric(t))
    assert rows == _rows(jfp.analyze_fabric(j)) and rows[0][0] == "fabric-qos-quota-floor"


# ---------------------------------------------------------------------------
# runtime hooks
# ---------------------------------------------------------------------------


def _doomed(fab_cls, **kw):
    fab = fab_cls(config=(FabricConfig if fab_cls is Fabric else JConfig)(
        frame_phits=2, credits=2, rx_frames=1), analyze=True, **kw)
    box = fab.mailbox(0)
    box.send(1, b"x" * 64)
    box.send(1, b"y" * 64)  # > rx_frames=1 at rank 1: static overflow
    return fab


def test_fabric_analyze_hook_pre_dispatch():
    """``analyze=True`` fails a doomed tick before dispatch with the
    reference's message; the sends stay queued and nothing was framed."""
    from repro_torch.kernels import frame_pack

    j = _doomed(JFabric, n_ranks=8)
    with pytest.raises(ValueError) as want:
        j.exchange()
    t = _doomed(Fabric, n_ranks=8, device="cpu")
    before = dict(frame_pack.LAUNCHES)
    with pytest.raises(ValueError, match="fabric-rx-overflow") as got:
        t.exchange()
    assert str(got.value) == str(want.value)
    assert len(t._pending) == 2 and t.exchanges == 0 and t._inflight is None
    assert frame_pack.LAUNCHES == before
    t._pending, t._pending_meta = [], []  # drop the doomed sends
    t.exchange()
    assert t.exchanges == 0


def test_fabric_analyze_at_construction():
    """WARN findings construct (the reference's quota-floor case); the
    config is checked against the topology as in the reference."""
    fab = Fabric(n_ranks=8, config=FabricConfig(frame_phits=2, credits=4,
                                                 qos_weights=(8, 1, 1)),
                 analyze=True, device="cpu")
    assert fab.analyze
    cfg = dict(frame_phits=2, credits=2, defect_after=8)
    Fabric(n_ranks=8, config=FabricConfig(**cfg), analyze=True, device="cpu")
    JFabric(n_ranks=8, config=JConfig(**cfg), analyze=True)


def test_serve_analyze_hook_matches_reference():
    fab = Fabric(n_ranks=8, config=FabricConfig(frame_phits=16, credits=4), device="cpu")
    tserve._analyze_serve(fab, 4, "test")
    assert fab.analyze  # armed for per-tick demand analysis
    jfab = JFabric(n_ranks=8, config=JConfig(frame_phits=16, credits=4))
    with pytest.raises(ValueError) as want:
        jserve._analyze_serve(jfab, 1 << 16, "test")
    with pytest.raises(ValueError, match="stream-id-width") as got:
        tserve._analyze_serve(fab, 1 << 16, "test")
    assert str(got.value) == str(want.value)
    armed = tserve.default_serve_fabric(2, analyze=True, device="cpu")
    assert armed.analyze and armed.n_ranks == 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_output_identical(tmp_path, capsys):
    """``--strict`` exits 0 over the shipped targets, and stdout (the
    per-target bounds, the report) and the JSON file equal the reference's;
    only the path named on the last line differs."""
    outs = {}
    for name, main in (("port", tmain.main), ("ref", jmain.main)):
        path = tmp_path / f"{name}.json"
        assert main(["--strict", "--json", str(path)]) == 0
        text = capsys.readouterr().out
        assert text.rstrip().endswith(f"findings written to {path}")
        outs[name] = (text.replace(str(path), "PATH"), json.loads(path.read_text()))
    assert outs["port"] == outs["ref"]
    assert outs["port"][1]["errors"] == 0 and set(outs["port"][1]["rules"]) == set(tan.RULES)
    assert tmain.main(["--quiet", "--json", "-"]) == 0
    assert "findings written" not in capsys.readouterr().out
