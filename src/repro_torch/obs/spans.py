"""Causal request spans: one id from ingress to first token.

A :class:`SpanTracker` mints a request id at ingress and every layer the
request touches appends events to it: the mailbox correlates deliveries
back through the route word's ``(src, dst, seq)`` range
(``Fabric.send(request_id=...)``), the continuous batcher marks
admit/evict, stream lanes mark first flush, and the serve loop marks the
first token.  The result is a *causal* record — which tick each leg
happened on — that the attribution report turns into per-request latency
breakdowns, with the tick marks telescoping exactly: the component sums
equal end-to-end TTFT in ticks by construction.

When a :class:`~repro_torch.obs.trace.TraceRecorder` is attached, every span
event also emits a Chrome-trace **flow event** (``ph: s/t/f``, one
shared ``id`` per request) anchored to a tiny slice, so a single request
renders as one connected arc across ranks and layers in Perfetto
(ui.perfetto.dev: enable "Flow events" in the track menu).

Degradation is first-class: a corrupted or gap-ridden delivery marks its
span ``degraded`` with the reason (``crc``/``seq-gap``), and a message
that cannot be correlated at all surfaces as a tracker *anomaly* — a
request can degrade but never silently vanish (property-tested under
seeded ``tx_hook`` corruption).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: bump when the export layout changes (readers ignore unknown keys)
SPANS_SCHEMA = 1

#: ordered tick marks of the serve pipeline and the component names of
#: the deltas between consecutive *present* marks; the final component
#: sum telescopes to ``first_token_tick - ingress_tick`` exactly.
TICK_MARKS: Tuple[str, ...] = (
    "serve.ingress", "batcher.admit", "stream.first_flush",
    "serve.first_token",
)
_DELTA_NAMES: Dict[Tuple[str, str], str] = {
    ("serve.ingress", "batcher.admit"): "admit_wait",
    ("batcher.admit", "stream.first_flush"): "decode",
    ("stream.first_flush", "serve.first_token"): "return",
}


@dataclass
class SpanEvent:
    """One point on a request's arc."""

    name: str
    ts_us: float
    tick: Optional[int] = None
    pid: int = 0
    args: Dict[str, object] = field(default_factory=dict)


@dataclass
class RequestSpan:
    """Everything recorded about one request id."""

    rid: int
    label: str
    args: Dict[str, object] = field(default_factory=dict)
    events: List[SpanEvent] = field(default_factory=list)
    #: accumulated numeric latency components (fabric.queue_wait, ...)
    components: Dict[str, float] = field(default_factory=dict)
    degraded: bool = False
    reasons: List[str] = field(default_factory=list)
    done: bool = False

    def first_tick(self, name: str) -> Optional[int]:
        for ev in self.events:
            if ev.name == name and ev.tick is not None:
                return ev.tick
        return None


def tick_breakdown(span: RequestSpan) -> Dict[str, int]:
    """Per-request latency breakdown in TICKS from the span's mark events.

    Deltas between consecutive present :data:`TICK_MARKS` (named
    ``admit_wait`` / ``decode`` / ``return``; a skipped mark merges its
    delta into the next one under a ``a->b`` key) plus ``ttft_ticks``,
    the end-to-end total.  Because the deltas are consecutive
    differences, ``sum(components) == ttft_ticks`` EXACTLY — the
    telescoping identity the attribution tests pin."""
    marks = [(n, span.first_tick(n)) for n in TICK_MARKS]
    present = [(n, t) for n, t in marks if t is not None]
    if len(present) < 2:
        return {}
    out: Dict[str, int] = {}
    for (a, ta), (b, tb) in zip(present, present[1:]):
        out[_DELTA_NAMES.get((a, b), f"{a}->{b}")] = tb - ta
    out["ttft_ticks"] = present[-1][1] - present[0][1]
    return out


class SpanTracker:
    """Mints request ids and collects their causal event arcs.

    Pure host-side bookkeeping (no device work, no syncs); with a
    ``trace`` attached it additionally emits Perfetto flow events.  All
    methods tolerate unknown rids by recording an anomaly instead of
    raising — a miswired call site must surface in the export, not crash
    the serve loop."""

    def __init__(self, trace=None, clock=None):
        self.trace = trace
        self._clock = clock
        self._t0 = time.perf_counter()
        self._next_rid = 1
        self._spans: Dict[int, RequestSpan] = {}
        self.anomalies: List[Dict[str, object]] = []
        self._tick: Optional[int] = None

    # -- time/tick bases ---------------------------------------------------

    def now_us(self) -> float:
        if self._clock is not None:
            return float(self._clock())
        if self.trace is not None:
            return self.trace.now_us()
        return (time.perf_counter() - self._t0) * 1e6

    def set_tick(self, tick: Optional[int]) -> None:
        """Set the serve-loop tick subsequent events are stamped with."""
        self._tick = None if tick is None else int(tick)

    # -- span lifecycle ----------------------------------------------------

    def start(self, label: str, pid: int = 0, **args) -> int:
        """Mint a request id and open its span (flow origin ``ph: s``)."""
        rid = self._next_rid
        self._next_rid += 1
        span = RequestSpan(rid=rid, label=label, args=dict(args))
        self._spans[rid] = span
        self._mark(span, label, pid, args, flow_ph="s")
        return rid

    def event(self, rid: int, name: str, pid: int = 0, **args) -> None:
        """Append one arc point (flow step ``ph: t``)."""
        span = self._spans.get(rid)
        if span is None:
            self.anomaly("span.unknown_rid", rid=rid, event=name, **args)
            return
        self._mark(span, name, pid, args, flow_ph="t")

    def finish(self, rid: int, pid: int = 0, **args) -> None:
        """Close the span (flow terminus ``ph: f``, binding point e)."""
        span = self._spans.get(rid)
        if span is None:
            self.anomaly("span.unknown_rid", rid=rid, event="finish", **args)
            return
        span.done = True
        self._mark(span, f"{span.label}.done", pid, args, flow_ph="f")

    def degrade(self, rid: int, reason: str, pid: int = 0, **args) -> None:
        """Mark the span degraded (corruption/gap) — annotated, kept."""
        span = self._spans.get(rid)
        if span is None:
            self.anomaly("span.unknown_rid", rid=rid, event="degrade",
                         reason=reason, **args)
            return
        span.degraded = True
        for r in reason.split(","):
            if r and r not in span.reasons:
                span.reasons.append(r)
        self._mark(span, "degraded", pid, dict(args, reason=reason),
                   flow_ph="t")

    def add_component(self, rid: int, name: str, value: float) -> None:
        """Accumulate a named latency component onto the span."""
        span = self._spans.get(rid)
        if span is None:
            self.anomaly("span.unknown_rid", rid=rid, component=name)
            return
        span.components[name] = span.components.get(name, 0) + value

    def anomaly(self, name: str, **args) -> None:
        """Record a tracker-level anomaly (uncorrelatable delivery,
        unknown rid) — visible in the export and on the trace."""
        self.anomalies.append(
            {"name": name, "ts_us": self.now_us(), "tick": self._tick,
             **args}
        )
        if self.trace is not None:
            self.trace.instant(name, cat="span.anomaly",
                               args={k: _jsonable(v) for k, v in args.items()})

    # -- internals ---------------------------------------------------------

    def _mark(self, span: RequestSpan, name: str, pid: int,
              args: Dict[str, object], flow_ph: str) -> None:
        ts = self.now_us()
        span.events.append(SpanEvent(
            name=name, ts_us=ts, tick=self._tick, pid=pid,
            args={k: _jsonable(v) for k, v in args.items()},
        ))
        if self.trace is None:
            return
        # a flow point must bind to a slice at the same (pid, tid, ts):
        # emit a 1us anchor slice plus the flow event sharing the span id
        ev_args = {"rid": span.rid, **{k: _jsonable(v) for k, v in args.items()}}
        if self._tick is not None:
            ev_args["tick"] = self._tick
        self.trace.complete(name, ts, 1.0, cat="span", pid=pid,
                            args=ev_args)
        flow = {
            "name": span.label, "ph": flow_ph, "cat": "span",
            "id": span.rid, "pid": pid, "tid": 0, "ts": ts,
        }
        if flow_ph == "f":
            flow["bp"] = "e"  # bind to the enclosing slice
        self.trace.events.append(flow)

    # -- views -------------------------------------------------------------

    def get(self, rid: int) -> Optional[RequestSpan]:
        return self._spans.get(rid)

    def requests(self) -> List[RequestSpan]:
        return [self._spans[r] for r in sorted(self._spans)]

    def export(self) -> dict:
        """JSON-ready dump: per-request events, components, degradation,
        and the tick breakdown — the flight-recorder attribution report
        artifact CI uploads."""
        return {
            "schema": SPANS_SCHEMA,
            "requests": [
                {
                    "rid": s.rid,
                    "label": s.label,
                    "args": s.args,
                    "done": s.done,
                    "degraded": s.degraded,
                    "reasons": list(s.reasons),
                    "components": dict(s.components),
                    "breakdown": tick_breakdown(s),
                    "events": [
                        {"name": e.name, "ts_us": e.ts_us, "tick": e.tick,
                         "pid": e.pid, "args": e.args}
                        for e in s.events
                    ],
                }
                for s in self.requests()
            ],
            "anomalies": [dict(a) for a in self.anomalies],
        }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:  # numpy scalars
        return v.item()
    except AttributeError:
        return str(v)
