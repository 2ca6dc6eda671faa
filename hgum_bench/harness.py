"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` is what ``run.py`` calls.  Set-up makes the weights on the
device from the seed, loads them into the program's model by name, and
serves one warm-up call of the cell's own shapes (which also builds or
loads the program's CUDA kernels).  The window then sends calls in a
closed loop, one client sending the next call when the last has answered;
it opens at the first call and closes at the end of the first call that
finishes after ``seconds``.  Rates are all the work of those calls over
all that time.

In a traced run (``trace=True``) the per-layer metrics install their
wrappers around calls into the program's layers, and the program's
streaming plane gets an ``obs`` trace and span tracker.  The window then
holds at least three calls and profiles two of them.  The second call
is profiled for device activity alone (``Run.profile``): its kernels,
copies and memsets give the busy time, which ``device_idle_share`` sets
against the wall of the run's unprofiled calls, since even these
per-launch records slow a launch-bound host.  The third is profiled with
the host's operators too (``Run.host_profile``): the benchmark's own
``record_function`` ranges attribute its kernels to layers and name what
the host did in its idle gaps, while the recording slows the host (by
30-40 % in a launch-bound decode), so its wall is no measure of idle
time.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional
from unittest import mock

import torch

from . import traffic
from .cells import Cell, load_family
from .devtrace import DeviceTrace
from .reference import check, weights
from .reference.codec import decode_response

#: reserved call index of the warm-up call's traffic
WARM_INDEX = (1 << 20) - 1

#: (module, attribute, owner class or None, range name): program calls the
#: traced run wraps in ``record_function`` ranges, for the device trace
ANNOTATED = [
    ("repro_torch.launch.serve", "decode_request_batch", None, "hgum.des"),
    ("repro_torch.launch.serve", "encode_response_batch", None, "hgum.ser"),
    ("repro_torch.runtime.scheduler", "step_begin", "ContinuousBatcher", "hgum.step_begin"),
    ("repro_torch.runtime.scheduler", "step_finish", "ContinuousBatcher", "hgum.step_finish"),
    ("repro_torch.fabric.mailbox", "exchange_async", "Fabric", "hgum.fabric.exchange_async"),
    ("repro_torch.fabric.mailbox", "poll", "Fabric", "hgum.fabric.poll"),
    ("repro_torch.fabric.mailbox", "exchange", "Fabric", "hgum.fabric.exchange"),
    ("repro_torch.stream", "flush_lanes", None, "hgum.flush_lanes"),
]


@dataclass
class Call:
    """One call of the window, as the client saw it."""

    index: int
    reqs: list
    sent: float = 0.0
    done: float = 0.0
    responses: Optional[list] = None
    #: streamed cells: (wire, prompt) -> [(step, token)] and arrival times
    stream_tokens: Dict = field(default_factory=dict)
    token_times: Dict = field(default_factory=dict)
    tokens: int = 0
    useful_flops: float = 0.0
    profiled: bool = False
    obs_trace: object = None
    spans: object = None


@dataclass
class Run:
    """What the metric readers see."""

    cell: Cell
    device: torch.device
    seed: int
    traced: bool
    calls: List[Call] = field(default_factory=list)
    current: Optional[Call] = None
    setup_s: float = 0.0
    window_s: float = 0.0
    #: the call profiled for device activity alone, and the call profiled
    #: with the host's operators and ranges too
    profile: Optional[DeviceTrace] = None
    host_profile: Optional[DeviceTrace] = None
    #: scratch space of the metric wrappers
    notes: Dict = field(default_factory=dict)

    def measured_calls(self) -> List[Call]:
        """The window's calls outside the profiler (all, if every call was
        profiled)."""
        return [c for c in self.calls if not c.profiled] or self.calls


def program_config(config: dict, family=None):
    """The program's ``ModelConfig``: the registry entry of ``arch`` with
    the overrides of ``family`` (by default ``cells.load_family``'s for
    ``config``)."""
    from dataclasses import replace

    from repro_torch.configs import get_config

    family = family or load_family(config)
    return replace(get_config(config["arch"]), **family.program_overrides(config))


def program_params(cfg, W: Dict[str, torch.Tensor]):
    """The program's model module holding the benchmark's tensors (no copy)."""
    from repro_torch.models.model import init_params

    lm = init_params(cfg, device="meta")
    have = dict(lm.named_parameters())
    if set(have) != set(W):
        raise ValueError(f"the program's parameters differ from the configuration's: "
                         f"{sorted(set(have) ^ set(W))[:8]}")
    for name, p in have.items():
        t = W[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: program {p.dtype}{tuple(p.shape)}, "
                             f"benchmark {t.dtype}{tuple(t.shape)}")
        owner, _, leaf = name.rpartition(".")
        setattr(lm.get_submodule(owner) if owner else lm, leaf,
                torch.nn.Parameter(t, requires_grad=False))
    return lm


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _annotations():
    """``record_function`` ranges around the program calls of ANNOTATED."""
    import importlib

    def ranged(fn, label):
        def call(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return call

    with contextlib.ExitStack() as stack:
        for mod_name, attr, owner, label in ANNOTATED:
            obj = importlib.import_module(mod_name)
            if owner is not None:
                obj = getattr(obj, owner)
            stack.enter_context(mock.patch.object(obj, attr, ranged(getattr(obj, attr), label)))
        yield


def _serve(run: Run, plane, call: Call, profile: Optional[str]) -> None:
    """Serve one call; ``profile`` is None, ``"device"`` (device activity
    alone) or ``"host"`` (the host's operators and ranges too)."""
    wires = traffic.wires(call.reqs)
    run.current = call
    if profile is None:
        call.sent = time.perf_counter()
        call.responses = plane.serve(wires, call)
        _sync(run.device)
        call.done = time.perf_counter()
        return
    from torch.profiler import ProfilerActivity, profile as profiler

    cuda = run.device.type == "cuda"
    if profile == "device" and cuda:
        acts = [ProfilerActivity.CUDA]
    else:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profiler(activities=acts) as prof:
        t0 = time.time_ns()
        call.sent = time.perf_counter()
        call.responses = plane.serve(wires, call)
        _sync(run.device)
        call.done = time.perf_counter()
        t1 = time.time_ns()
    call.profiled = True
    # summarised after the window: the events of a long call are millions
    # of Python objects, and building them here would slow the next calls
    run.notes[f"profiler.{profile}"] = (prof, t0, t1, call.done - call.sent)


def _window(run: Run, plane, seconds: float) -> None:
    cell, mix = run.cell, run.cell.mix
    n_wires = int(cell.workload["wires_per_call"])
    vocab = int(cell.config["vocab_size"])
    profiled = {1: "device", 2: "host"} if run.traced else {}
    min_calls = 1 + len(profiled)
    t_open = time.perf_counter()
    i = 0
    while True:
        call = Call(i, traffic.call(mix, n_wires, vocab, run.seed, i))
        _serve(run, plane, call, profile=profiled.get(i))
        run.calls.append(call)
        how = f", profiled ({profiled[i]})" if i in profiled else ""
        print(f"call {i}: {call.done - call.sent:.3f} s, sent {call.sent - t_open:.3f} s "
              f"into the window{how}", file=sys.stderr)
        i += 1
        if call.done - t_open >= seconds and len(run.calls) >= min_calls:
            break
    run.window_s = run.calls[-1].done - t_open


def _count_work(run: Run) -> None:
    """Tokens delivered and useful FLOPs of each call (after the window)."""
    sequence_flops = run.cell.family.sequence_flops
    for c in run.calls:
        if run.cell.plane.STREAMED:
            c.tokens = sum(len(v) for v in c.stream_tokens.values())
        else:
            n = 0
            for w in c.responses or []:
                try:
                    n += sum(len(o) for o in decode_response(w)[1])
                except (ValueError, TypeError):
                    pass
            c.tokens = n
        gen = int(run.cell.mix["max_new"])
        c.useful_flops = sum(sequence_flops(run.cell.config, len(p), gen)
                             for _, prompts in c.reqs for p in prompts)


def _streamed(c: Call) -> dict:
    """Each stream's tokens as they reached the ingress, in step order
    (None for a stream that sent none)."""
    return {(m, j): [t for _, t in sorted(c.stream_tokens[(m, j)])]
            if (m, j) in c.stream_tokens else None
            for m, (_, prompts) in enumerate(c.reqs) for j in range(len(prompts))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: Optional[str] = None, control: bool = False,
             control_quant: bool = True) -> dict:
    """One run; returns the result object (``run.py`` prints it).  With
    ``control`` it also holds the check's readings (``control.py``), the
    float8 control's too where ``control_quant``."""
    dev = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference's float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = program_config(cell.config, cell.family)
    W = weights.make(cell.config, seed, dev, cell.family.spec)
    params = program_params(cfg, W)
    run = Run(cell, dev, seed, trace)
    plane = cell.plane.Plane(cell, cfg, params, dev, trace)
    warm = Call(WARM_INDEX, traffic.call(cell.mix, plane.warm_wires, int(
        cell.config["vocab_size"]), seed, WARM_INDEX))
    plane.serve(traffic.wires(warm.reqs), warm)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - t_start

    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(_annotations())
            for mod in cell.per_layer.values():
                if hasattr(mod, "install"):
                    stack.enter_context(mod.install(run))
        _window(run, plane, seconds)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    for kind, attr in (("device", "profile"), ("host", "host_profile")):
        if f"profiler.{kind}" in run.notes:
            prof, t0, t1, wall = run.notes.pop(f"profiler.{kind}")
            setattr(run, attr, DeviceTrace(prof.profiler.kineto_results.events(), t0, t1, wall))
            del prof
    _count_work(run)
    if trace:
        readers, got = cell.per_layer, {}
    else:
        readers, got = cell.end_to_end, {}
    for name, mod in readers.items():
        v = mod.read(run)
        if v is not None:
            got[name] = {"value": float(v), "unit": mod.UNIT}

    # free the program's state before the reference runs
    del plane, params, W
    from repro_torch.launch.steps import clear_serve_step_cache

    clear_serve_step_cache()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    calls = [{"reqs": c.reqs, "responses": c.responses,
              "streamed": _streamed(c) if cell.plane.STREAMED else None} for c in run.calls]
    verdict = check.judge(cell.config, cell.mix, cell.workload, calls, seed, dev,
                          control=control and control_quant, family=cell.family)
    ok = all(v <= lim for v, lim in verdict["checks"].values())
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(ok), "attempted": sum(len(c.reqs) for c in run.calls),
           "failed": int(verdict["failed"]), "metrics": got, "device": device_info}
    if trace and run.profile is not None:
        device_info["busy_s"] = run.profile.busy_s
        device_info["window_s"] = run.profile.wall_s
        named = run.host_profile or run.profile
        out["breakdown"] = {"device_ops": run.profile.device_ops(),
                            "idle_gaps": named.idle_gaps()}
    if control:
        out["readings"] = verdict["readings"]
        out["sampled"] = verdict["sampled"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["checks"].items()}
    return out
