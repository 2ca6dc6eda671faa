"""Training driver: HGum data pipeline + checkpoint/restart + watchdog.

Counterpart of ``repro.launch.train``, on the card by default (``--device
cpu`` runs on the host).  Each step's Batch wire is made on the host by a
prefetch thread and decoded on the device by the DES kernels.  Fault
tolerance:

* atomic HGum-framed checkpoints every ``--ckpt-every`` steps (keep-K),
* ``--resume auto`` restores the newest valid checkpoint (bitwise: step,
  params, optimizer moments, data seed),
* straggler watchdog: a step slower than 3x the trailing median forces an
  early checkpoint at the next boundary,
* simulated failures (``--die-at N``, exit code 17) for the restart tests.

A restart is bitwise only if every step is: the loop runs with
``torch.use_deterministic_algorithms(True)`` (and ``CUBLAS_WORKSPACE_CONFIG``
set before the process's first cuBLAS call), so the embedding's backward
and ``index_add_`` take their deterministic forms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --steps 50 --ckpt-dir /tmp/run1 --resume auto
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
from typing import Dict, Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, smoke_config
from ..data import HGumBatchPipeline, Prefetcher
from ..data.pipeline import decode_batch
from ..data.prefetch import StragglerWatchdog
from ..device import DeviceLike, default_device
from ..models import init_params
from ..optim import AdamWConfig, adamw_init, linear_warmup_cosine
from .steps import make_train_step


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside the block, the caller's mode after.
    cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` when it first runs in a
    process, so it is set here only where the caller has not set it."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def train_loop(
    arch: str,
    steps: int = 50,
    batch: int = 4,
    seq: int = 64,
    smoke: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    resume: str = "no",
    die_at: Optional[int] = None,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    prefetch: int = 2,
    device: DeviceLike = None,
) -> Dict:
    dev = default_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    cfg = dataclasses.replace(cfg, microbatch=1)

    with deterministic():
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        opt_state = adamw_init(params)
        opt_cfg = AdamWConfig(lr=lr)
        step_fn = make_train_step(cfg, opt_cfg, linear_warmup_cosine(lr, 10, steps))

        start_step = 0
        mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        if mgr and resume == "auto":
            latest, restored = mgr.restore_latest({"params": params, "opt": opt_state})
            if latest is not None:
                params, opt_state = restored["params"], restored["opt"]
                start_step = latest
                print(f"[train] resumed from step {start_step}")

        pipe = HGumBatchPipeline(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed, device=dev)
        # deterministic resume: fast-forward the host pipeline
        for _ in range(start_step):
            pipe.host_make_wire()

        pf = Prefetcher(pipe.host_make_wire, depth=prefetch)
        dog = StragglerWatchdog()
        losses = []
        force_ckpt = False
        try:
            for step in range(start_step, steps):
                if die_at is not None and step == die_at:
                    print(f"[train] simulated failure at step {step}", flush=True)
                    pf.close()
                    sys.exit(17)
                wire = pf.get()
                b = decode_batch(wire, batch, seq, device=dev)
                dog.start()
                params, opt_state, metrics = step_fn(params, opt_state, b)
                loss = float(metrics["loss"])
                slow = dog.stop()
                force_ckpt |= slow
                losses.append(loss)
                if step % log_every == 0 or step == steps - 1:
                    print(
                        f"[train] step {step:5d} loss {loss:7.4f} "
                        f"gnorm {float(metrics.get('grad_norm', 0)):6.3f}"
                        + (" STRAGGLER" if slow else ""),
                        flush=True,
                    )
                at_boundary = (step + 1) % ckpt_every == 0 or step == steps - 1
                if mgr and (at_boundary or force_ckpt):
                    mgr.save(step + 1, {"params": params, "opt": opt_state},
                             meta={"arch": arch, "loss": loss})
                    force_ckpt = False
        finally:
            pf.close()
    return {
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "steps": len(losses),
        "stragglers": dog.flagged,
        "params": params,
        "opt_state": opt_state,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--die-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    out = train_loop(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        smoke=args.smoke, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, die_at=args.die_at, lr=args.lr, seed=args.seed,
        device=args.device,
    )
    print(f"[train] done: first_loss={out['first_loss']:.4f} "
          f"final_loss={out['final_loss']:.4f} stragglers={out['stragglers']}")


if __name__ == "__main__":
    main()
