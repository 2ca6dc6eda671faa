"""End-to-end training on the PyTorch/CUDA port (~100M-param model, a few
hundred steps).

The twin of ``examples/train_lm.py`` on ``repro_torch``.  Everything is the
production path at reduced scale: the HGum-wire input pipeline (host SER
in a prefetch thread, device DES: two B3 ``unpack_gather`` launches a
step), AdamW with fp32 master, HGum-framed checkpoints with keep-K and
auto-resume, the straggler watchdog, all under deterministic algorithms
(``repro_torch.launch.train.train_loop``).

Run (fast demo: yi-6b's smoke config, 8 x 128 tokens a step):
  PYTHONPATH=src python examples/torch_train_lm.py --steps 120 [--device cpu]

Full ~100M config (12 layers x 768, gelu, float32, vocab 50304; 8 x 256
tokens a step, a checkpoint every 50 steps):
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --full

``--resume auto`` restores the newest checkpoint in ``--ckpt-dir``; give
each configuration its own directory.  It runs on the CUDA card unless
given ``--device cpu``; without a card and without ``--device cpu`` it
raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, register
from repro_torch.device import default_device
from repro_torch.launch.train import train_loop

#: the --full model: a gpt2-small-like decoder, registered on the fly
DEMO_100M = ModelConfig(
    name="demo-100m", family="lm", n_layers=12, d_model=768,
    n_heads=12, n_kv=12, d_ff=3072, vocab=50304, act="gelu",
    dtype="float32", microbatch=1,
)


def register_demo() -> None:
    """Register ``demo-100m`` once per process."""
    try:
        register(DEMO_100M)
    except ValueError:  # already registered
        pass


def train(steps: int, full: bool, ckpt_dir: str, device) -> Dict:
    if full:
        register_demo()
        return train_loop("demo-100m", steps=steps, batch=8, seq=256, smoke=False,
                          ckpt_dir=ckpt_dir, ckpt_every=50, resume="auto", lr=6e-4,
                          device=device)
    return train_loop("yi-6b", steps=steps, batch=8, seq=128, smoke=True,
                      ckpt_dir=ckpt_dir, ckpt_every=40, resume="auto", lr=1e-3,
                      device=device)


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--full", action="store_true",
                    help="~100M params (12L x 768d) instead of the tiny demo")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "hgum_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    t0 = time.perf_counter()
    out = train(args.steps, args.full, args.ckpt_dir, dev)
    ms = 1e3 * (time.perf_counter() - t0) / max(out["steps"], 1)
    print(f"\nfirst loss {out['first_loss']:.3f} -> final {out['final_loss']:.3f} "
          f"({out['steps']} steps, {out['stragglers']} straggler steps) on {dev}, "
          f"{ms:.1f} ms a step (host clock; init and checkpoints included)")
    assert out["final_loss"] < out["first_loss"], "loss must fall"
    return out


if __name__ == "__main__":
    main()
