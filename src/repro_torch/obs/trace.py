"""Chrome-trace / Perfetto JSON timeline export.

A :class:`TraceRecorder` collects events in the Chrome Trace Event Format
(the JSON array form under a ``traceEvents`` key), which both
``chrome://tracing`` and https://ui.perfetto.dev load directly:

* ``complete(name, start_us, dur_us)`` / ``span(name)`` — duration slices
  (``ph: "X"``): fabric ticks, decode ticks, bench modules;
* ``instant(name)`` — point events (``ph: "i"``): per-stream chunk
  arrivals, deliveries (with the router ``arrive_step`` — the
  in-tick scan-step timeline — in ``args``);
* ``counter(name, values)`` — counter tracks (``ph: "C"``): live scan
  steps per tick, queue depths, occupancy.

Timestamps are microseconds since the recorder was created
(``time.perf_counter`` based — monotonic, sub-tick resolution).  The
recorder reads that clock and the Unix-epoch clock together once, at
creation (:attr:`TraceRecorder.anchor`, written under ``otherData``), so
``ts`` lays onto ``torch.profiler``'s timeline, which stamps Unix-epoch
nanoseconds: ``epoch_ns = anchor[1] + ts * 1000``.  Tracks
are named via pid/tid metadata events (``process_name``/``thread_name``),
so fabric ranks and serve shards render as separate rows.

:func:`validate_trace` is the CI schema gate: it checks a loaded trace
is a well-formed Chrome-trace event stream (list shape, required keys,
known phases, numeric timestamps) without constraining event *content*,
so new event kinds stay forward-compatible.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

#: event phases this recorder emits (validate_trace accepts the superset
#: chrome://tracing documents, so hand-written traces can use more)
PH_COMPLETE, PH_INSTANT, PH_COUNTER, PH_META = "X", "i", "C", "M"
KNOWN_PHASES = frozenset("BEXiICMPSTFsftNODabe()")


class TraceRecorder:
    """Collects Chrome-trace events; ``save()`` writes the JSON object."""

    def __init__(self) -> None:
        #: (``time.perf_counter_ns()``, ``time.time_ns()``) at ts 0
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self._t0 = self.anchor[0] / 1e9
        self.events: List[dict] = []
        self._named: set = set()

    def now_us(self) -> float:
        """Microseconds since the recorder started (event timebase)."""
        return (time.perf_counter() - self._t0) * 1e6

    def _base(self, name: str, ph: str, cat: str, pid: int, tid: int,
              ts: Optional[float], args: Optional[dict]) -> dict:
        ev = {
            "name": name, "ph": ph, "cat": cat, "pid": pid, "tid": tid,
            "ts": self.now_us() if ts is None else float(ts),
        }
        if args:
            ev["args"] = args
        return ev

    def name_track(self, pid: int, process: str,
                   tid: Optional[int] = None,
                   thread: Optional[str] = None) -> None:
        """Label a pid (and optionally a tid) row; idempotent."""
        key = (pid, None)
        if key not in self._named:
            self._named.add(key)
            self.events.append({
                "name": "process_name", "ph": PH_META, "pid": pid, "tid": 0,
                "ts": 0.0, "args": {"name": process},
            })
        if tid is not None and (pid, tid) not in self._named:
            self._named.add((pid, tid))
            self.events.append({
                "name": "thread_name", "ph": PH_META, "pid": pid, "tid": tid,
                "ts": 0.0, "args": {"name": thread or f"tid {tid}"},
            })

    def instant(self, name: str, cat: str = "obs", pid: int = 0,
                tid: int = 0, ts: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        ev = self._base(name, PH_INSTANT, cat, pid, tid, ts, args)
        ev["s"] = "t"  # thread-scoped instant
        self.events.append(ev)

    def complete(self, name: str, start_us: float, dur_us: float,
                 cat: str = "obs", pid: int = 0, tid: int = 0,
                 args: Optional[dict] = None) -> None:
        ev = self._base(name, PH_COMPLETE, cat, pid, tid, start_us, args)
        ev["dur"] = max(0.0, float(dur_us))
        self.events.append(ev)

    def span(self, name: str, cat: str = "obs", pid: int = 0, tid: int = 0,
             args: Optional[dict] = None) -> "_Span":
        """``with trace.span("serve.tick"):`` — a complete event whose
        duration is the with-block's wall time."""
        return _Span(self, name, cat, pid, tid, args)

    def counter(self, name: str, values: Dict[str, float], cat: str = "obs",
                pid: int = 0, ts: Optional[float] = None) -> None:
        self.events.append(
            self._base(name, PH_COUNTER, cat, pid, 0, ts,
                       {k: float(v) for k, v in values.items()})
        )

    # -- export ------------------------------------------------------------

    def to_json(self) -> dict:
        """The JSON-object form chrome://tracing / Perfetto load."""
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"clock_anchor": {"perf_counter_ns": self.anchor[0],
                                           "unix_ns": self.anchor[1]}},
        }

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
            f.write("\n")


class _Span:
    def __init__(self, rec: TraceRecorder, name: str, cat: str, pid: int,
                 tid: int, args: Optional[dict]):
        self.rec, self.name, self.cat = rec, name, cat
        self.pid, self.tid, self.args = pid, tid, args

    def __enter__(self) -> "_Span":
        self._start = self.rec.now_us()
        return self

    def __exit__(self, *exc) -> None:
        self.rec.complete(self.name, self._start,
                          self.rec.now_us() - self._start, cat=self.cat,
                          pid=self.pid, tid=self.tid, args=self.args)


def validate_trace(obj) -> List[str]:
    """Schema-check a loaded trace JSON; returns problems (empty = valid).

    Accepts both the JSON-object form (``{"traceEvents": [...]}``) and
    the bare JSON-array form — the two shapes chrome://tracing loads.
    Event ``args`` and unknown extra keys are not constrained
    (forward-compatible, like the metrics snapshot contract)."""
    errs: List[str] = []
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            return ["object form must carry a 'traceEvents' list"]
    elif isinstance(obj, list):
        events = obj
    else:
        return [f"trace must be a dict or list, got {type(obj).__name__}"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not a dict")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errs.append(f"{where}: missing event name")
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in KNOWN_PHASES:
            errs.append(f"{where} ({ev.get('name')}): unknown phase {ph!r}")
            continue
        if ph != PH_META and not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"{where} ({ev.get('name')}): missing numeric ts")
        if ph == PH_COMPLETE and not isinstance(ev.get("dur"), (int, float)):
            errs.append(f"{where} ({ev.get('name')}): X event missing dur")
        if ph == PH_COUNTER and not isinstance(ev.get("args"), dict):
            errs.append(f"{where} ({ev.get('name')}): C event missing args")
    return errs
