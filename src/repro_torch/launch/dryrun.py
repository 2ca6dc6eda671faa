"""Dry run: what each (arch x shape x mesh) cell needs per device, and
whether it fits an H100.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles every cell for a TPU pod on 512 fake host devices; the port
answers the same question on the ``meta`` device, with nothing
allocated.  For each cell this driver:

1. builds the mesh (16x16 single-pod / 2x16x16 multi-pod, or
   ``--mesh-shape``) and resolves the runtime's shardings against the
   step's inputs (:func:`lower_cell`; a spec that does not fit fails the
   cell);
2. sizes per-device memory exactly from the shardings: argument bytes
   (each input leaf's ``shard_shape``), output bytes, and alias bytes
   (donated inputs that the outputs overwrite).  There is no compiler to
   report temporaries, so ``temp_bytes`` is ``null`` and ``fits`` compares
   arguments + outputs - aliases with the card's memory: a floor, not a
   measurement;
3. costs the step (``launch.costanalysis``) by running it on ``meta``
   tensors, and splits the cost evenly over the mesh's ranks (flops and
   bytes / n_chips; replicated work is not charged twice).  The port's
   attention is a Python loop over tiles, so a full-depth trace is many
   thousand dispatches a layer (a hundred thousand at 32 K tokens, where
   a ``meta`` op costs about 0.2 ms of host): the step is traced with no
   layers and with one period of the layer plan (and, for a train step
   with more than three microbatches, with two and three microbatches),
   and the counts, linear in both, are extended to the config's depth
   and microbatch count, as the reference's analyzer multiplies ``while``
   trip counts.  The traces run the layers unscanned (``scan_layers``
   changes the order of nothing but the MoE balance loss's bookkeeping).
   The extension is exact (``tests/test_torch_dryrun.py`` holds it to a
   full trace), but for an MoE train step: a model with no layers has no
   balance-loss term, so its few scalar ops count once per period;
4. takes the collective term from the layout (``"collective_source":
   "layout"``), per device and step:

   * FSDP gathers: each parameter leaf's per-device slice times the
     product of its spec's non-tensor axes minus one (the slices a rank
     gathers), once per use: forward and backward of each microbatch for
     train, once for prefill and decode;
   * gradient sums over the data-parallel axes (train, once a step, in
     float32): a reduce-scatter, ``(dp - 1) / dp`` of the tensor-axis
     slice, where the gradient layout shards the leaf over them, an
     all-reduce (twice that) where it does not;
   * tensor-axis reductions: one all-reduce, ``2 (t - 1) / t`` of the
     per-device activation ``(b, S, d_model)``, after the embedding and
     after each layer's mixer and FFN, once a pass; a train step runs
     three passes a microbatch (forward, recomputation, backward) with
     remat and two without;

5. writes one JSON per cell into ``--out`` with the roofline terms at the
   H100's constants (``launch.costanalysis``).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import SHAPES, all_archs, get_config, supports_shape
from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import cache_zeros, plan_period
from ..optim import AdamWConfig
from ..runtime.actshard import mesh_constrainer, use_constrainer
from ..runtime.sharding import (
    NamedSharding,
    P,
    ShardRules,
    batch_pspec,
    batch_shardings,
    cache_shardings,
    leaf_paths,
    param_shardings,
    with_sharding_constraint,
)
from .costanalysis import (
    HBM_BW,
    HBM_BYTES,
    NVLINK_BW,
    PEAK_FLOPS,
    CostReport,
    analyze,
    roofline_terms,
)
from .mesh import Mesh, make_production_mesh
from .steps import (
    cache_specs,
    input_specs,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

HBM_PER_CHIP = HBM_BYTES


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D (train) / 2*N*D (fwd-only), N = active params (MoE-aware)."""
    n = cfg.param_counts()["active"]
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch  # decode: one token per row


def lower_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: Mesh,
    rules: Optional[ShardRules] = None,
    donate: bool = True,
):
    """Returns ``(step, shardings, specs)`` for one cell.

    ``specs`` are the step's inputs on ``meta`` (``steps.input_specs``);
    ``shardings`` holds ``"in"`` (one tree per step argument) and
    ``"out"`` (per output; ``None`` where the reference leaves the layout
    to the compiler), ``"donate"`` (the donated argument indices) and, for
    train, ``"grads"``.
    ``step`` runs the cell's step on any device: it checks its arguments
    and outputs against those shardings, runs with the activation
    constrainer installed (``step.constrainer`` keeps its records), and
    gives exactly the unsharded step's numbers.  For train, the optimizer
    state and the gradients shard ZeRO-style over ``("pod", fsdp)`` on a
    multi-pod mesh, and the microbatches over the batch axes."""
    rules = rules or ShardRules()
    specs = input_specs(cfg, shape)
    psh = param_shardings(specs["params"], cfg, mesh, rules)
    if shape.kind == "train":
        opt_rules = rules
        if "pod" in mesh.axis_names and isinstance(rules.fsdp, str):
            opt_rules = dataclasses.replace(rules, fsdp=("pod", rules.fsdp))
        osh = param_shardings(specs["opt_state"], cfg, mesh, opt_rules)
        gsh = param_shardings(specs["params"], cfg, mesh, opt_rules)
        bsh = batch_shardings(specs["batch"], mesh, rules, global_batch=shape.global_batch)
        bspec = batch_pspec(mesh, rules, shape.global_batch // max(cfg.microbatch, 1))

        def micro_sharding_fn(tree):
            for x in tree.values():
                spec = P(None, *(list(bspec) + [None] * (x.ndim - 2)))
                with_sharding_constraint(x, NamedSharding(mesh, spec))
            return tree

        inner = make_train_step(
            cfg, AdamWConfig(moments=cfg.opt_moments), grad_shardings=gsh,
            micro_sharding_fn=micro_sharding_fn if cfg.microbatch > 1 else None,
        )
        shardings = {"in": (psh, osh, bsh), "out": (psh, osh, None), "grads": gsh,
                     "donate": (0, 1) if donate else ()}
    elif shape.kind == "prefill":
        bsh = batch_shardings(specs["batch"], mesh, rules, global_batch=shape.global_batch)
        csh_out = cache_shardings(
            cache_specs(cfg, shape.global_batch, shape.seq_len), cfg, mesh, rules)
        inner = make_prefill_step(cfg)
        shardings = {"in": (psh, bsh), "out": (None, csh_out), "donate": ()}
    else:  # decode
        csh = cache_shardings(specs["cache"], cfg, mesh, rules)
        tsh = batch_shardings(specs["tokens"], mesh, rules, global_batch=shape.global_batch)
        inner = make_serve_step(cfg)
        shardings = {"in": (psh, csh, tsh), "out": (tsh, csh),
                     "donate": (1,) if donate else ()}
    constrainer = mesh_constrainer(mesh, rules, shape.global_batch)

    def step(*args):
        for arg, sh in zip(args, shardings["in"]):
            with_sharding_constraint(arg, sh)
        with use_constrainer(constrainer):
            out = inner(*args)
        for o, sh in zip(out, shardings["out"]):
            if sh is not None:
                with_sharding_constraint(o, sh)
        return out

    step.constrainer = constrainer
    return step, shardings, specs


# ---------------------------------------------------------------------------
# memory, cost, collectives
# ---------------------------------------------------------------------------


def tree_bytes(tree, shardings=None) -> int:
    """Per-device bytes of ``tree`` under ``shardings`` (a tree of the same
    paths, one sharding, or ``None``: replicated)."""
    by_path = (dict(leaf_paths(shardings))
               if shardings is not None and not isinstance(shardings, NamedSharding) else {})
    total = 0
    for path, leaf in leaf_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        sh = by_path.get(path, shardings) if by_path else shardings
        local = tuple(leaf.shape) if sh is None else sh.shard_shape(tuple(leaf.shape))
        total += math.prod(local) * leaf.element_size()
    return total


def _trace(cfg: ModelConfig, shape: ShapeConfig):
    """(CostReport, outputs) of the unsharded step run on ``meta``."""
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        step = make_train_step(cfg, AdamWConfig(moments=cfg.opt_moments))
        args = (specs["params"], specs["opt_state"], specs["batch"])
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
        args = (specs["params"], specs["batch"])
    else:
        step = make_serve_step(cfg)
        args = (specs["params"], specs["cache"], specs["tokens"])
    out, rep = analyze(step, *args)
    return rep, out


def _combine(reps: Dict, coeffs: Dict) -> CostReport:
    """sum of c * report over ``coeffs`` (integer coefficients)."""
    out = CostReport()
    for key, c in coeffs.items():
        if not c:
            continue
        r = reps[key]
        out.flops += c * r.flops
        out.dot_flops += c * r.dot_flops
        out.hbm_bytes += c * r.hbm_bytes
        for name in ("collective_op_bytes", "collective_out_bytes", "collective_count"):
            acc = getattr(out, name)
            for k, v in getattr(r, name).items():
                acc[k] = acc.get(k, 0) + c * v
    return out


def _line_weights(points, target: int) -> Dict[int, int]:
    """Weights of the line through one or two consecutive integer points
    at ``target``."""
    if len(points) == 1:
        return {points[0]: 1}
    d = target - points[0]
    return {points[0]: 1 - d, points[1]: d}


@functools.lru_cache(maxsize=16)
def step_cost(cfg: ModelConfig, shape: ShapeConfig):
    """(CostReport of the whole step, outputs of one traced step): traces
    of no and one layer period (and two and three microbatches) extended
    linearly to ``cfg``'s depth and microbatch count (module docstring)."""
    period = plan_period(cfg)
    k = cfg.n_layers // period
    # an encdec's encoder is initialised by its decoder depth: it needs one
    base = 1 if cfg.family == "encdec" else 0
    periods = (base, base + 1) if k > base + 1 else (k,)
    n_micro = cfg.microbatch if shape.kind == "train" else 1
    micros = (2, 3) if n_micro > 3 else (n_micro,)
    per_micro = shape.global_batch // max(n_micro, 1)
    reps, outs = {}, None
    for a in periods:
        for m in micros:
            c = dataclasses.replace(cfg, n_layers=a * period, scan_layers=False,
                                    microbatch=m if shape.kind == "train" else cfg.microbatch)
            s = dataclasses.replace(shape, global_batch=per_micro * max(m, 1))
            reps[a, m], outs = _trace(c, s)
    # the counts are bilinear in (periods, microbatches): the tensor product
    # of the two linear extrapolations is exact
    wa, wm = _line_weights(periods, k), _line_weights(micros, n_micro)
    rep = _combine(reps, {(a, m): wa[a] * wm[m] for a in wa for m in wm})
    rep.notes.append(f"traced {len(reps)} step(s) on meta: periods {periods} of {period} "
                     f"layer(s), microbatches {micros}; extended to {cfg.n_layers} layers, "
                     f"{n_micro} microbatch(es)")
    return rep, outs


def _spec_factor(mesh: Mesh, spec, exclude=()) -> int:
    f = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            if a not in exclude:
                f *= mesh.shape[a]
    return f


def layout_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, rules: ShardRules,
                       shardings, specs) -> Dict[str, float]:
    """Per-device bytes a step's layout moves, by collective kind (module
    docstring, step 4)."""
    t_ax = rules.tensor
    train = shape.kind == "train"
    n_micro = max(cfg.microbatch, 1) if train else 1
    psh = shardings["in"][0]
    params = dict(leaf_paths(specs["params"]))
    gather = reduce_scatter = all_reduce = 0.0
    uses = 2 * n_micro if train else 1
    for path, sh in leaf_paths(psh):
        leaf = params[path]
        local = math.prod(sh.shard_shape(tuple(leaf.shape))) * leaf.element_size()
        gather += uses * local * (_spec_factor(mesh, sh.spec, exclude=(t_ax,)) - 1)
    if train:
        gsh = dict(leaf_paths(shardings["grads"]))
        dp_axes = tuple(a for a in rules.batch if a in mesh.shape)
        dp = math.prod(mesh.shape[a] for a in dp_axes)
        for path, leaf in params.items():
            spec = gsh[path].spec
            t_f = _spec_factor(mesh, spec) // _spec_factor(mesh, spec, exclude=(t_ax,))
            slice_b = leaf.numel() // t_f * 4
            if _spec_factor(mesh, spec, exclude=(t_ax,)) > 1:
                reduce_scatter += slice_b * (dp - 1) / dp
            else:
                all_reduce += 2 * slice_b * (dp - 1) / dp
    t = mesh.shape.get(t_ax, 1)
    if t > 1:
        b = shape.global_batch // n_micro
        b_local = b // _spec_factor(mesh, batch_pspec(mesh, rules, b))
        seq = 1 if shape.kind == "decode" else shape.seq_len
        act = b_local * seq * cfg.d_model * torch.finfo(getattr(torch, cfg.dtype)).bits // 8
        reductions = 1 + sum(1 + (f != "none") for f in cfg.ffn_kinds())
        passes = (3 if cfg.remat else 2) * n_micro if train else 1
        all_reduce += passes * reductions * 2 * (t - 1) / t * act
    out = {"all-gather": gather, "reduce-scatter": reduce_scatter, "all-reduce": all_reduce}
    return {k: v for k, v in out.items() if v}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _parse_overrides(pairs):
    """["k=v", ...] -> dict with literal-ish coercion."""
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    rules: Optional[ShardRules] = None,
    scan: Optional[bool] = None,
    out_dir: str = "experiments/dryrun",
    tag: str = "",
    cfg_overrides: Optional[Dict] = None,
    mesh_shape: Optional[tuple] = None,
) -> Dict:
    rules = rules or ShardRules()
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, reason = supports_shape(cfg, shape)
    result: Dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "status": "skipped", "reason": reason,
    }
    if not ok:
        _write(result, out_dir)
        return result

    # scan-over-layers, as the reference picks it
    if scan is None:
        scan = cfg.family == "lm" and shape.kind == "train"
    cfg = dataclasses.replace(cfg, scan_layers=scan)

    if mesh_shape is not None:  # re-factor the 256 ranks
        mesh = Mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):])
    else:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size
    t0 = time.time()
    try:
        _, shardings, specs = lower_cell(cfg, shape, mesh, rules)
        t_lower = time.time() - t0
        t0 = time.time()
        rep, outs = step_cost(cfg, shape)
        t_trace = time.time() - t0
        ins = shardings["in"]
        args = [specs[k] for k in (("params", "opt_state", "batch") if shape.kind == "train"
                                   else ("params", "batch") if shape.kind == "prefill"
                                   else ("params", "cache", "tokens"))]
        arg_b = [tree_bytes(a, sh) for a, sh in zip(args, ins)]
        if shape.kind == "train":
            out_b = arg_b[0] + arg_b[1] + tree_bytes(outs[2])
        elif shape.kind == "prefill":
            cache = cache_zeros(cfg, shape.global_batch, shape.seq_len, shape.seq_len,
                                device="meta")
            out_b = tree_bytes(outs[0]) + tree_bytes(cache, shardings["out"][1])
        else:
            out_b = tree_bytes(outs[0], shardings["out"][0]) + arg_b[1]
        alias_b = sum(arg_b[i] for i in shardings["donate"])
        coll = layout_collectives(cfg, shape, mesh, rules, shardings, specs)
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        result.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-2000:])
        _write(result, out_dir)
        return result

    per_dev_bytes = sum(arg_b) + out_b - alias_b
    dev = CostReport(flops=rep.flops / n_chips, dot_flops=rep.dot_flops / n_chips,
                     hbm_bytes=rep.hbm_bytes / n_chips, collective_op_bytes=coll,
                     notes=rep.notes + [f"flops and bytes: the step's / {n_chips} ranks; "
                                        "collectives: from the layout"])
    terms = roofline_terms(dev)
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_flops_global = rep.flops
    result.update(
        status="ok",
        reason="",
        n_chips=n_chips,
        lower_s=round(t_lower, 2),
        trace_s=round(t_trace, 2),
        scan_layers=scan,
        collective_source="layout",
        device={"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
                "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
                "hbm_bytes": HBM_PER_CHIP},
        memory={
            "argument_bytes": sum(arg_b),
            "output_bytes": out_b,
            "temp_bytes": None,
            "alias_bytes": alias_b,
            "per_device_bytes": per_dev_bytes,
            "hbm_frac": per_dev_bytes / HBM_PER_CHIP,
            "fits": bool(per_dev_bytes <= HBM_PER_CHIP),
            "note": "temp_bytes: no compiler to report temporaries; per_device_bytes "
                    "= arguments + outputs - aliases, a floor",
        },
        hlo=dev.as_dict(),
        roofline={
            **terms,
            "dominant": dominant,
            "model_flops_global": mf,
            "hlo_flops_global": hlo_flops_global,
            "useful_ratio": mf / hlo_flops_global if hlo_flops_global else None,
            "step_time_bound_s": max(terms.values()),
            "mfu_bound": mf / (max(terms.values()) * n_chips * PEAK_FLOPS)
            if max(terms.values()) > 0 else None,
        },
    )
    _write(result, out_dir)
    return result


def _write(result: Dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"_{result['tag']}" if result.get("tag") else ""
    fn = f"{result['arch']}_{result['shape']}_{result['mesh']}{tag}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(result, f, indent=1, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--scan", default=None, choices=[None, "on", "off"])
    ap.add_argument("--seq-sharded", action="store_true")
    ap.add_argument("--no-ep", action="store_true")
    ap.add_argument("--no-kv-heads", action="store_true")
    ap.add_argument("--set", nargs="*", default=None, metavar="K=V",
                    help="ModelConfig overrides, e.g. remat_policy=dots")
    ap.add_argument("--rules", nargs="*", default=None, metavar="K=V",
                    help="ShardRules overrides, e.g. batch=pod,data,model")
    ap.add_argument("--mesh-shape", default=None,
                    help="re-factor the ranks, e.g. 32,8")
    args = ap.parse_args(argv)

    rules = ShardRules(
        expert_parallel=not args.no_ep,
        kv_head_sharded=not args.no_kv_heads,
        seq_sharded_acts=args.seq_sharded,
    )
    rule_over = _parse_overrides(args.rules)
    if "batch" in rule_over:
        rule_over["batch"] = tuple(rule_over["batch"].split(","))
    if rule_over:
        rules = dataclasses.replace(rules, **rule_over)
    cfg_over = _parse_overrides(args.set)
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    scan = None if args.scan is None else (args.scan == "on")
    archs = all_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                r = run_cell(arch, shape, mk, rules, scan, args.out, args.tag,
                             cfg_overrides=cfg_over, mesh_shape=mesh_shape)
                line = f"{arch:28s} {shape:12s} {mk:6s} {r['status']:8s}"
                if r["status"] == "ok":
                    rf = r["roofline"]
                    line += (
                        f" trace={r['trace_s']:7.1f}s"
                        f" mem/dev={r['memory']['per_device_bytes']/2**30:6.2f}GiB"
                        f" fits={r['memory']['fits']!s:5s}"
                        f" dom={rf['dominant'][2:]:10s}"
                        f" t=({rf['t_compute']*1e3:8.3f},{rf['t_memory']*1e3:8.3f},"
                        f"{rf['t_collective']*1e3:8.3f})ms"
                    )
                elif r["status"] == "FAILED":
                    line += " " + r.get("error", "")[:90]
                else:
                    line += " " + r.get("reason", "")[:70]
                print(line, flush=True)


if __name__ == "__main__":
    main()
