"""Port parity, the examples: each ``examples/torch_*.py`` twin against its
JAX example (``examples/*.py``) on the CPU, at the examples' own sizes.

* quickstart: the ROM text, the wire, the DES tokens and cycles, the kernel
  decode ``[17, 51]`` (the reference's ``decode_message_kernel`` in
  interpret mode) and the HW->HW loopback's frames, bytes and cycles; the
  printed text equal to the reference script's but for the decode lines.
* moe_dispatch: given the reference's ``x`` and MoE parameters (through
  numpy), capacity, per-expert counts, ``moe_dropped`` and the top-k
  experts equal, ``moe_balance_loss`` within ``rtol=1e-5``; the routed
  lists, frames routed and per-rank loads of the all-to-all equal to the
  reference's fabric on 8 fake devices (a subprocess with XLA_FLAGS).
* serve_requests: with the reference's parameters (``params_from_jax``),
  every response wire byte-identical on the batched, sharded and streaming
  planes (the default 7 shards on both sides).
* typed_streams: the golden bytes and the planned logprob stream equal.
* train_lm: the smoke run's loss falls, and its final loss is exactly
  ``train_loop``'s at the same seed (the reference's train CLI dies in
  ``pl.load`` on this JAX, so it is no oracle).

Each twin also runs as a script with ``--device cpu`` in a process where
importing ``jax`` or ``repro`` raises.
"""
import dataclasses
import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro import core as jcore
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.kernels import decode_message_kernel as j_decode_message_kernel
from repro.kernels import wire_to_u32 as j_wire_to_u32
from repro.launch import serve as jserve
from repro.models.ffn import init_moe_ffn as j_init_moe_ffn
from repro.models.ffn import moe_capacity as j_moe_capacity
from repro.models.ffn import moe_ffn as j_moe_ffn
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.train import train_loop
from repro_torch.models.ffn import init_moe_ffn
from torch_parity import twin_models

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ["torch_quickstart", "torch_serve_requests", "torch_typed_streams",
         "torch_moe_dispatch", "torch_train_lm"]


def _twin(name):
    spec = importlib.util.spec_from_file_location(f"examples_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_matches_reference(capsys):
    qs = _twin("torch_quickstart")
    got = qs.main(["--device", "cpu"])
    twin_out = capsys.readouterr().out
    runpy.run_path(str(EXAMPLES / "quickstart.py"), run_name="__main__")
    ref_out = capsys.readouterr().out

    schema = jcore.Schema.from_json(qs.SCHEMA_JSON)
    client = jcore.ClientSchema.from_json(qs.CLIENT_JSON)
    rom = jcore.build_rom(schema, client)
    wire = jcore.ser_sw_to_hw(schema, qs.MSG)
    res = jcore.DesFSM(rom, "sw2hw").run(wire)
    dec = j_decode_message_kernel(j_wire_to_u32(wire), jcore.build_plan(schema, qs.MSG))
    xs = list(jcore.lanes_to_int(np.asarray(dec["a.elem.elem.x"]), 4))
    ser = jcore.SerFSM(rom, "hw2hw", frame_phits=4).run(jcore.strip_for_ser(res.tokens))
    back = jcore.DesFSM(rom, "hw2hw").run(ser.wire)

    assert got["rom"] == rom.describe()
    assert got["wire"] == wire and got["wire"].hex() == (
        "010000000200000011000000220000000000000033000000440000000000000009")
    assert got["des_cycles"] == res.cycles == 10
    assert got["tokens"] == [str(t) for t in res.tokens]
    assert got["xs"] == xs == [17, 51]
    assert (got["frames"], got["hw_wire_bytes"], got["ser_cycles"], got["des_hw_cycles"]) == (
        ser.frames, len(ser.wire), ser.cycles, back.cycles) == (2, 65, 13, 12)
    assert got["routes"]["a.elem.elem.x"] == "B1 unpack_run_aligned (strided)"
    # the printed text: the reference's lines, the decode lines aside
    ref_lines = [ln for ln in ref_out.splitlines() if "Pallas decode" not in ln]
    twin_lines = [ln for ln in twin_out.splitlines()
                  if not ln.startswith(("kernel decode", "   "))]
    assert twin_lines == [ln for ln in ref_lines if not ln.startswith("   ")]
    assert "kernel decode on cpu of a[.][.].x -> [17, 51]" in twin_out


# ---------------------------------------------------------------------------
# moe_dispatch
# ---------------------------------------------------------------------------


def _moe_reference():
    """The reference example's model, input and routing (PRNGKey(0))."""
    cfg = j_smoke_config(j_get_config("mixtral-8x22b"))
    key = jax.random.PRNGKey(0)
    p = j_init_moe_ffn(key, cfg, jnp.float32)
    x = jax.random.normal(key, (4, 32, cfg.d_model))
    _, aux = j_moe_ffn(p, x, cfg)
    logits = x.reshape(-1, cfg.d_model) @ p["router"]
    top = np.asarray(jax.lax.top_k(jax.nn.softmax(logits), cfg.moe_topk)[1].reshape(-1))
    return cfg, p, x, aux, top


def test_moe_routing_matches_reference():
    md = _twin("torch_moe_dispatch")
    jcfg, jp, jx, jaux, jtop = _moe_reference()
    cfg = smoke_config(get_config("mixtral-8x22b"))
    p = init_moe_ffn(cfg, torch.float32, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    r = md.route(p, torch.from_numpy(np.asarray(jx)), cfg)
    assert r["capacity"] == j_moe_capacity(jcfg, 4 * 32) == 80
    np.testing.assert_array_equal(r["top"], jtop)
    np.testing.assert_array_equal(r["counts"], np.bincount(jtop, minlength=jcfg.moe_experts))
    assert list(r["counts"]) == [68, 65, 69, 54]
    assert r["dropped"] == float(jaux["moe_dropped"])
    np.testing.assert_allclose(r["balance_loss"], float(jaux["moe_balance_loss"]), rtol=1e-5)


_MOE_REFERENCE_FABRIC = r"""
import contextlib, io, json, sys
import numpy as np
sys.path[:0] = [{src!r}, {examples!r}]
from repro.fabric import mailbox
got = {{}}
recv = mailbox.Mailbox.recv
def recording(self, *a, **k):
    out = recv(self, *a, **k)
    got[self.rank] = [[d.src, d.list_level, np.frombuffer(d.wire, np.uint32).tolist(), d.ok]
                      for d in out]
    return out
mailbox.Mailbox.recv = recording
import moe_dispatch
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    moe_dispatch.main()
print(json.dumps({{"stdout": buf.getvalue(), "received": got}}))
"""


def test_moe_all_to_all_matches_reference_fabric():
    """The reference example on 8 fake devices (4 ranks for its 4
    experts): the twin's all-to-all of the reference's top-k delivers the
    same lists, in the same order, over the same number of frames."""
    md = _twin("torch_moe_dispatch")
    jcfg, _, _, _, top = _moe_reference()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    code = _MOE_REFERENCE_FABRIC.format(src=str(ROOT / "src"), examples=str(EXAMPLES))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    stdout = ref["stdout"]
    assert "4 ranks, 32 frames routed, crc_ok=True" in stdout
    assert "fabric all-to-all bit-exact: True" in stdout

    R = min(md.MAX_RANKS, jcfg.moe_experts)
    out = md.expert_all_to_all(top, jcfg.moe_experts, R, "cpu")
    assert out["n_ranks"] == R == 4
    assert out["frames_routed"] == 32 and out["crc_ok"] and out["bit_exact"]
    for d in range(R):
        want = ref["received"][str(d)]
        assert [[s, e + 1, ids.tolist(), True] for s, e, ids in out["received"][d]] == want
    for d, loads in enumerate(md.rank_loads(out["received"])):
        assert f"  rank {d}: 4 routed lists, expert loads {loads}" in stdout
    assert md.rank_loads(out["received"]) == [{0: 68}, {1: 65}, {2: 69}, {3: 54}]


# ---------------------------------------------------------------------------
# serve_requests and typed_streams
# ---------------------------------------------------------------------------


def _reference_burst(cfg, pad_to):
    """The reference example's burst, built as it builds it."""
    rng = np.random.default_rng(0)
    wires = []
    for req_id in range(4):
        n_prompts = int(rng.integers(1, 5))
        prompts = [list(map(int, rng.integers(2, cfg.vocab, rng.integers(pad_to, pad_to + 8))))
                   for _ in range(n_prompts)]
        wires.append(jserve.encode_request(req_id, prompts))
    return wires


def test_serve_requests_matches_reference():
    sr = _twin("torch_serve_requests")
    jcfg, jparams, cfg, tparams = twin_models("yi-6b", n_layers=sr.N_LAYERS)
    wires = sr.burst(cfg)
    assert wires == _reference_burst(jcfg, sr.PAD_TO)
    kw = dict(max_new=sr.MAX_NEW, pad_to=sr.PAD_TO, slots=8)
    want = jserve.serve_requests(jparams, jcfg, wires, **kw)
    jfab = jserve.default_serve_fabric(None)
    assert jfab.n_ranks == 8
    want_sharded = jserve.serve_requests_sharded(jparams, jcfg, wires, fabric=jfab, **kw)
    want_streamed = jserve.serve_requests_streaming(jparams, jcfg, wires,
                                                    fabric=jserve.default_serve_fabric(None),
                                                    overlap=True, **kw)
    got = sr.batched(tparams, cfg, wires, "cpu")
    got_sharded, fab = sr.sharded(tparams, cfg, wires, None, "cpu")
    got_streamed, sfab, arrivals = sr.streaming(tparams, cfg, wires, None, "cpu")
    assert fab.n_ranks == sfab.n_ranks == 8
    assert got == want
    assert got_sharded == want_sharded == want
    assert got_streamed == want_streamed == want
    assert fab.frames_routed == jfab.frames_routed
    assert jserve.decode_response(got[0]) == jserve.decode_response(want[0])
    assert len(arrivals) == sum(len(o) for w in got for o in jserve.decode_response(w)[1])


def test_typed_streams_matches_reference():
    ts = _twin("torch_typed_streams")
    from repro.stream import encode_chunk_burst as j_encode_chunk_burst
    from repro.stream import logprob_stream_plan as j_logprob_stream_plan

    golden = ts.GOLDEN.read_bytes()
    assert ts.check_golden_fixture("cpu") == golden
    assert j_encode_chunk_burst(ts.golden_chunks()) == golden
    plan, jplan = ts.logprob_stream_plan(), j_logprob_stream_plan()
    for f in dataclasses.fields(jplan):
        assert getattr(plan, f.name) == getattr(jplan, f.name), f.name
    assert (plan.n_leaves, plan.elem_words) == (2, 2)

    jcfg, jparams, cfg, tparams = twin_models("yi-6b", n_layers=ts.N_LAYERS)
    wires = ts.burst(cfg)
    out = ts.streamed_logprobs(tparams, cfg, wires, "cpu")
    want = jserve.serve_requests(jparams, jcfg, wires, max_new=ts.MAX_NEW, pad_to=ts.PAD_TO,
                                 slots=8)
    assert out["batched"] == out["plain"] == out["with_lp"] == want
    assert {k: [t for t, _ in v] for k, v in out["lps"].items()} == out["toks"]


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

TRAIN_STEPS = 12


def test_train_lm_loss_falls_and_is_train_loops(tmp_path, capsys):
    tl = _twin("torch_train_lm")
    out = tl.main(["--steps", str(TRAIN_STEPS), "--device", "cpu",
                   "--ckpt-dir", str(tmp_path / "twin")])
    assert f"({TRAIN_STEPS} steps" in capsys.readouterr().out
    assert out["final_loss"] < out["first_loss"]
    direct = train_loop("yi-6b", steps=TRAIN_STEPS, batch=8, seq=128, smoke=True,
                        ckpt_dir=str(tmp_path / "direct"), ckpt_every=40, resume="auto",
                        lr=1e-3, device="cpu")
    assert out["first_loss"] == direct["first_loss"]
    assert out["final_loss"] == direct["final_loss"]


def test_demo_100m_is_the_reference_config(monkeypatch):
    """``--full`` registers the reference example's ``demo-100m`` (here into
    a copy of the registry, so no other test sees it)."""
    from repro.configs.base import ModelConfig as JModelConfig
    from repro_torch.configs import base

    base.all_archs()
    monkeypatch.setattr(base, "_REGISTRY", dict(base._REGISTRY))
    tl = _twin("torch_train_lm")
    want = JModelConfig(name="demo-100m", family="lm", n_layers=12, d_model=768, n_heads=12,
                        n_kv=12, d_ff=3072, vocab=50304, act="gelu", dtype="float32",
                        microbatch=1)
    assert dataclasses.asdict(tl.DEMO_100M) == dataclasses.asdict(want)
    tl.register_demo()
    tl.register_demo()  # idempotent
    assert get_config("demo-100m") == tl.DEMO_100M


# ---------------------------------------------------------------------------
# each twin as a script, on the CPU, without JAX
# ---------------------------------------------------------------------------

_NO_JAX = r"""
import runpy, sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("the twin imported " + name)
sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, {src!r})
sys.argv = [{script!r}] + {args!r}
runpy.run_path({script!r}, run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("NO_JAX_OK")
"""

SCRIPT_ARGS = {
    "torch_quickstart": [],
    "torch_serve_requests": [],
    "torch_typed_streams": [],
    "torch_moe_dispatch": [],
    "torch_train_lm": ["--steps", str(TRAIN_STEPS)],
}
SCRIPT_SAYS = {
    "torch_quickstart": "loopback OK",
    "torch_serve_requests": "[sequential] same burst, same tokens",
    "torch_typed_streams": "tokens byte-identical with and without the extra stream",
    "torch_moe_dispatch": "fabric all-to-all bit-exact: True",
    "torch_train_lm": f"({TRAIN_STEPS} steps",
}


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_on_cpu_without_jax(name, tmp_path):
    args = SCRIPT_ARGS[name] + ["--device", "cpu"]
    if name == "torch_train_lm":
        args += ["--ckpt-dir", str(tmp_path / "ckpt")]
    code = _NO_JAX.format(src=str(ROOT / "src"), script=str(EXAMPLES / f"{name}.py"),
                          args=args)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert SCRIPT_SAYS[name] in res.stdout and "NO_JAX_OK" in res.stdout


@pytest.mark.parametrize("name", TWINS)
def test_twin_needs_the_card_by_default(name):
    """Without ``--device cpu`` a twin runs on CUDA, and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from repro_torch.device import NoCudaError

    with pytest.raises(NoCudaError, match="device='cpu'"):
        _twin(name).main([])


def test_twins_keep_the_reference_flags():
    """Every flag of each JAX example is a flag of its twin, in the same
    order; the twins add only ``--device``, and import neither JAX nor the
    JAX package."""
    for name in TWINS:
        ref = (EXAMPLES / f"{name[len('torch_'):]}.py").read_text()
        twin = (EXAMPLES / f"{name}.py").read_text()
        flags = re.findall(r'add_argument\("(--[a-z-]+)"', ref)
        tflags = re.findall(r'add_argument\("(--[a-z-]+)"', twin)
        assert tflags == flags + ["--device"], name
        assert "import jax" not in twin and "from repro." not in twin and "import repro\n" \
            not in twin
