"""Run one cell of the benchmark once, on one CUDA card.

    python3 hgum_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (request wires), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown`` of the traced call, and
last ``checks``: each number the correctness check compared, with its
limit (also printed as the last lines of standard error).

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program (``src/repro_torch``), or
when the process has loaded JAX or the JAX package.  Build and kernel
caches stay inside the checkout; the program's CUDA kernels build into
``src/repro_torch/kernels/build/`` on the first run there.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
#: top-level module names the run may never load
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _caches() -> None:
    cache = CHECKOUT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded), compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    if not (CHECKOUT / "src" / "repro_torch").is_dir():
        print("run.py: the program (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 2

    import torch

    from hgum_bench import cells
    from hgum_bench.harness import run_cell

    cell = cells.load(args.workload)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"run.py: {args.workload} needs {need} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
