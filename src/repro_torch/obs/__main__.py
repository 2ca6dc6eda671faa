"""CLI: summarize, schema-check, diff, or SLO-gate telemetry artifacts.

::

    python -m repro_torch.obs metrics.json              # render a text report
    python -m repro_torch.obs trace.json --validate     # schema-check (CI gate)
    python -m repro_torch.obs diff a.json b.json        # compare two snapshots
    python -m repro_torch.obs attribution spans.json    # latency breakdown table
    python -m repro_torch.obs slo "ttft_p95_s=0.5" --metrics m.json

The single-file form auto-detects the kind: a ``traceEvents`` key (or a
bare JSON array) is a Chrome trace; anything with a ``metrics`` list is
a metrics snapshot (a wrapping ``meta`` block is surfaced, not
required).  With ``--validate`` the exit code is nonzero on any schema
problem — that is what CI runs against the uploaded artifacts.  The
subcommands dispatch on the first argument, so the legacy single-file
invocation keeps working unchanged."""
from __future__ import annotations

import argparse
import json
import sys

from .metrics import validate_snapshot
from .report import render_text
from .trace import validate_trace

SUBCOMMANDS = ("diff", "attribution", "slo")


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot load {path}: {e}", file=sys.stderr)
        raise SystemExit(2)


def _cmd_diff(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs diff",
        description="Compare two metrics snapshots (new/removed/changed "
        "metrics with delta + ratio).",
    )
    ap.add_argument("a", help="baseline snapshot JSON")
    ap.add_argument("b", help="candidate snapshot JSON")
    ap.add_argument("--json", action="store_true", help="machine output")
    ap.add_argument("--fail-on-change", action="store_true",
                    help="exit nonzero when the snapshots differ")
    args = ap.parse_args(argv)
    from .report import diff_snapshots, render_diff

    diff = diff_snapshots(_load_json(args.a), _load_json(args.b))
    print(json.dumps(diff, indent=1) if args.json else render_diff(diff))
    n = sum(len(diff[k]) for k in ("added", "removed", "changed"))
    return 1 if (args.fail_on_change and n) else 0


def _cmd_attribution(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs attribution",
        description="Render a spans export (serve --attribution-json) as "
        "per-request / per-class latency-breakdown tables.",
    )
    ap.add_argument("file", help="spans export JSON")
    ap.add_argument("--json", action="store_true",
                    help="emit the flattened rows as JSON")
    args = ap.parse_args(argv)
    from .report import attribution_rows, render_attribution

    export = _load_json(args.file)
    if args.json:
        print(json.dumps(attribution_rows(export), indent=1))
    else:
        print(render_attribution(export))
    return 0


def _cmd_slo(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs slo",
        description="Evaluate declared SLO targets against a metrics "
        "snapshot; exit 1 on any violated objective.",
    )
    ap.add_argument("spec", help="inline 'k=v,k=v' spec or JSON file path")
    ap.add_argument("--metrics", required=True,
                    help="metrics snapshot JSON to evaluate against")
    ap.add_argument("--window", type=int, default=None,
                    help="restrict series objectives to the last N samples")
    args = ap.parse_args(argv)
    from .slo import evaluate_slo

    rep = evaluate_slo(args.spec, snapshot=_load_json(args.metrics),
                       window=args.window)
    print(rep.render_text())
    return 0 if rep.ok else 1


def _detect(obj) -> str:
    if isinstance(obj, list):
        return "trace"
    if isinstance(obj, dict):
        if "traceEvents" in obj:
            return "trace"
        if isinstance(obj.get("metrics"), list):
            return "metrics"
    return "unknown"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # subcommand dispatch on the FIRST token only, so the legacy
    # single-file form (`python -m repro_torch.obs metrics.json --validate`,
    # what CI runs) is untouched — a file named "diff" would need ./diff
    if argv and argv[0] in SUBCOMMANDS:
        return {
            "diff": _cmd_diff,
            "attribution": _cmd_attribution,
            "slo": _cmd_slo,
        }[argv[0]](argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize or validate a repro telemetry artifact "
        "(metrics snapshot or Chrome-trace JSON); subcommands: "
        "diff, attribution, slo.",
    )
    ap.add_argument("file", help="metrics snapshot or trace JSON file")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check only; exit nonzero on problems")
    ap.add_argument("--kind", choices=("auto", "metrics", "trace"),
                    default="auto", help="override artifact detection")
    args = ap.parse_args(argv)

    try:
        with open(args.file) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot load {args.file}: {e}", file=sys.stderr)
        return 2

    kind = _detect(obj) if args.kind == "auto" else args.kind
    if kind == "unknown":
        print(f"error: {args.file} is neither a metrics snapshot nor a "
              "Chrome trace (use --kind to force)", file=sys.stderr)
        return 2

    if kind == "trace":
        errs = validate_trace(obj)
        n = len(obj if isinstance(obj, list) else obj.get("traceEvents", []))
        if errs:
            for e in errs:
                print(f"invalid trace: {e}", file=sys.stderr)
            return 1
        print(f"{args.file}: valid Chrome trace, {n} events")
        if not args.validate:
            names = {}
            events = obj if isinstance(obj, list) else obj["traceEvents"]
            for ev in events:
                if isinstance(ev, dict) and ev.get("ph") != "M":
                    names[ev.get("name")] = names.get(ev.get("name"), 0) + 1
            for name, cnt in sorted(names.items()):
                print(f"  {name}: {cnt}")
        return 0

    errs = validate_snapshot(obj)
    if errs:
        for e in errs:
            print(f"invalid snapshot: {e}", file=sys.stderr)
        return 1
    if args.validate:
        print(f"{args.file}: valid metrics snapshot, "
              f"{len(obj.get('metrics', []))} metrics")
        return 0
    meta = obj.get("meta")
    if isinstance(meta, dict):
        ident = " ".join(
            f"{k}={meta[k]}" for k in
            ("backend", "device_kind", "n_devices", "torch_version",
             "cuda_version", "git_sha")
            if meta.get(k) is not None
        )
        if ident:
            print(f"meta: {ident}")
    print(render_text(obj))
    return 0


if __name__ == "__main__":  # pragma: no cover
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # `... | head` closed the pipe mid-report
        raise SystemExit(0)
