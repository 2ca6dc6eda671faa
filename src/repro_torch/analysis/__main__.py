"""CLI: run every static pass over every shipped target.

    PYTHONPATH=src python -m repro_torch.analysis [--strict] [--json PATH]

Human report on stdout (per-target findings + busiest-link summary of the
bench demand matrices), JSON findings + rule catalog to ``--json`` (
``analysis_findings.json`` by default).  ``--strict`` exits 1 on any
ERROR finding — the CI lint gate.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from .comm import busiest_links, total_frames
from .config_passes import analyze_model_config
from .fabric_passes import analyze_demand, analyze_fabric_values
from .findings import Report
from .schema_passes import analyze_schema, analyze_stream_schema, wire_bounds
from .targets import (
    demand_targets,
    fabric_targets,
    model_config_targets,
    schema_targets,
    stream_targets,
)


def run_all(verbose: bool = False) -> Report:
    """Analyze every shipped target; returns the aggregated Report."""
    report = Report()
    lines: List[str] = []

    for loc, schema, client, caps in schema_targets():
        fs = report.extend(analyze_schema(
            schema, client=client, caps=caps, location=loc,
        ))
        report.targets += 1
        wb = wire_bounds(schema)
        hi = wb.max_bytes if wb.max_bytes is not None else "unbounded"
        lines.append(
            f"  schema {loc}: wire [{wb.min_bytes}, {hi}] B, "
            f"min {wb.min_frames(16)} frames @ 16 phits, "
            f"{len(fs)} finding(s)"
        )

    for loc, schema in stream_targets():
        fs = report.extend(analyze_stream_schema(schema, location=loc))
        report.targets += 1
        try:
            from ..core.stream_plans import stream_plans

            shapes = ", ".join(
                f"{p}: {plan.n_leaves} leaves x {plan.elem_words} word(s)"
                for p, plan in sorted(stream_plans(schema).items())
            )
        except Exception:
            shapes = "no plan (see findings)"
        lines.append(f"  stream {loc}: {shapes}; {len(fs)} finding(s)")

    for loc, kw in fabric_targets():
        fs = report.extend(analyze_fabric_values(location=loc, **kw))
        report.targets += 1
        lines.append(f"  fabric {loc}: {len(fs)} finding(s)")

    for loc, sizes, cfg_kw, srcs, dsts, counts, levels in demand_targets():
        from ..fabric.router import FabricConfig

        cfg = FabricConfig(**cfg_kw)
        loads, fs = analyze_demand(
            sizes, cfg, srcs, dsts, counts, levels=levels, location=loc,
        )
        report.extend(fs)
        report.targets += 1
        busy = busiest_links(loads, top=1)
        peak = (f"peak link axis {busy[0][0]} ring {busy[0][1]} "
                f"dir {busy[0][2]}: {busy[0][3]} frames over "
                f"{busy[0][4]} hops") if busy else "no traffic"
        lines.append(
            f"  demand {loc}: {total_frames(loads)} frames on the "
            f"busiest axis; {peak}; {len(fs)} finding(s)"
        )

    for loc, cfg in model_config_targets():
        fs = report.extend(analyze_model_config(cfg, location=loc))
        report.targets += 1
        lines.append(f"  config {loc}: {len(fs)} finding(s)")

    if verbose:
        print("\n".join(lines))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any ERROR finding (CI gate)")
    ap.add_argument("--json", default="analysis_findings.json",
                    metavar="PATH",
                    help="write the JSON findings file here ('-' skips)")
    ap.add_argument("--quiet", action="store_true",
                    help="summary line only (no per-target bounds)")
    args = ap.parse_args(argv)

    report = run_all(verbose=not args.quiet)
    print(report.render())
    if args.json != "-":
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2)
        print(f"findings written to {args.json}")
    if args.strict and report.errors:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
