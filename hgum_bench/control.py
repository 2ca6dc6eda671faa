"""Readings that set the limits of a cell's gap statistics, on the chip.

    python3 hgum_bench/control.py --workload <cell> --seeds 11,12,13 [--control-seeds 3]

For each seed, in one process: one call of the cell at its own load
(weights from the seed, the warm-up, one call, the check), and prints one
JSON line with the program's gap statistics (the lower readings, from a
sound run) and, for the first ``--control-seeds`` seeds, the control's:
the reference in float8 at the same positions, the gaps of the tokens it
puts first (the upper readings).  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    import torch

    from hgum_bench import cells
    from hgum_bench.harness import run_cell

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 3
    cell = cells.load(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(cell, seed, 0.0, False, t, control=True,
                       control_quant=i < args.control_seeds)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "checks": out["checks"], "readings": out.get("readings"),
                          "sampled": out.get("sampled"), "attempted": out["attempted"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
