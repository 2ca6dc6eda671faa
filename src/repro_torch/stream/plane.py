"""StreamWriter / StreamReader: per-request token streams over the fabric.

Counterpart of ``repro.stream.plane``; the same events on the same inputs.

The writer side lives on a serving shard.  A :class:`ChunkLane` owns the
(shard -> ingress, tenant) direction: every live sequence holds a
:class:`StreamWriter` on the lane, ``write`` queues that decode step's
tokens as a :class:`~repro_torch.stream.chunks.TokenChunk`, and one
``flush`` per tick serializes ALL of the lane's chunks in a single batched
kernel launch on the fabric's device (``encode_chunk_burst``, the B7 CUDA
kernel on the card) and mails the burst as ONE fabric message tagged
with the lane's ``list_level`` — the QoS class the router's weighted
round-robin credit scheduler keys on.

The reader side lives at the ingress.  :meth:`StreamReader.feed` consumes
fabric :class:`~repro_torch.fabric.mailbox.Delivery` records, parses each burst
back-to-front, and demultiplexes chunks into per-``(src, stream_id)``
:class:`StreamState`s:

* **ordering** — bursts arrive per (src, dst) in fabric-seq order and each
  chunk carries its stream-local ``step``; a step gap or a chunk after EOS
  marks the stream corrupt (lost/duplicated burst), mirroring the frame-seq
  gap rule one layer down;
* **corruption** — a delivery whose frames failed CRC32 (or whose burst
  does not parse) poisons exactly the streams whose chunks rode in it; all
  other streams stay clean — the per-stream analog of the fabric's
  per-message flags;
* **termination** — the explicit EOS chunk closes the stream; readers know
  a stream is complete without any out-of-band length.

``feed`` returns the tick's fresh :class:`StreamEvent`s so a serve loop can
hand tokens to callers the moment they reach the ingress (time-to-first-
token = one decode tick + one fabric tick, not the whole generation).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.stream_plans import (
    Fragment,
    StreamPlan,
    decode_fragments,
    encode_fragment_burst,
)
from ..obs.metrics import window_stats
from .chunks import TokenChunk, decode_token_chunks, encode_chunk_burst

#: the ONE shared arrive-window implementation (``obs.metrics``): kept
#: under its historical name here for the benchmarks and tests that import
#: ``repro_torch.stream.arrive_stats``.  ``Fabric.class_arrive_stats`` and
#: :meth:`StreamReader.class_arrive_stats` both resolve to this same
#: function, so the two ends of the backpressure feedback loop can never
#: disagree on what "p95" means (see obs.metrics.window_stats for the
#: ceil-rank percentile definition).
arrive_stats = window_stats


@dataclass
class StreamEvent:
    """Tokens from one chunk the moment it reached the reader."""

    src: int
    stream_id: int
    step: int
    tokens: Tuple[int, ...]
    eos: bool
    ok: bool
    #: router scan step of the carrying message; None when the delivery
    #: carried no latency observation (never fabricated as 0 — a fake
    #: zero-latency sample would deflate the mean/p95 the backpressure
    #: scheduler feeds on and inflate jitter)
    arrive_step: Optional[int] = None


class StreamWriter:
    """Write side of one token stream (one generating sequence)."""

    def __init__(self, lane: "ChunkLane", stream_id: int):
        self.lane = lane
        self.stream_id = stream_id
        self.step = 0
        self.closed = False

    def write(self, tokens: Sequence, eos: bool = False) -> None:
        """Queue one decode step's elements; sent at the lane's next flush.

        Elements follow the lane's generated plan: plain ints for the
        default token lane (and any single-leaf plan), tuples of ints in
        leaf order for multi-leaf element types.
        """
        if self.closed:
            raise RuntimeError(f"stream {self.stream_id} already closed")
        plan = self.lane.plan
        if plan is None or plan.n_leaves == 1:
            elems = tuple(int(t) for t in tokens)
        else:
            elems = tuple(tuple(int(v) for v in e) for e in tokens)
        cls = TokenChunk if plan is None else Fragment
        self.lane._pending.append(cls(self.stream_id, self.step, elems, eos))
        self.step += 1
        self.closed = eos

    def close(self) -> None:
        """Emit the explicit end-of-stream terminator chunk (idempotent)."""
        if not self.closed:
            self.write((), eos=True)


class ChunkLane:
    """Batches one tick's chunks from one rank to one destination (one QoS
    class) into a single fabric message.

    **Backpressure-fed flush clamping** (``p95_threshold``): the reader
    side surfaces per-QoS-class arrive-step percentiles
    (:meth:`StreamReader.class_arrive_stats` /
    ``Fabric.class_arrive_stats``); feeding them back via :meth:`feedback`
    clamps the lane's flush rate while its class's p95 in-fabric latency
    sits above the threshold.  A clamped lane *trickles*: each flush mails
    only its oldest ``clamp_chunks`` chunks (default 1) and holds the rest
    for later bursts, so its QoS class presents almost no frames at the
    router's inject step and its WRR credit quota spills to the other
    classes — a stalled tenant stops inflating everyone else's queues,
    while its own stream keeps trickling forward (never a stop-then-dump
    that would slam a multi-tick mega-burst into the link).  With
    ``clamp_chunks=0`` the lane holds entirely, bounded by ``max_hold``
    consecutive held flushes.  Held chunks ride later bursts in write
    order, so the reader sees the same step sequence and reassembled
    tokens whether or not the clamp ever engaged.
    """

    def __init__(self, mailbox, dst: int, list_level: int = 1,
                 p95_threshold: Optional[float] = None,
                 clamp_chunks: int = 1, max_hold: int = 3,
                 metrics=None, plan: Optional[StreamPlan] = None):
        self.mailbox = mailbox
        self.dst = dst
        self.list_level = list_level
        #: generated ``core.stream_plans.StreamPlan`` this lane serializes
        #: with; None = the shipped token plan (``chunks.py`` codec).  Any
        #: ``Stream<T>`` declared in schema JSON rides the lane unchanged.
        self.plan = plan
        self.p95_threshold = p95_threshold
        self.clamp_chunks = clamp_chunks
        self.max_hold = max_hold
        self._pending: List[TokenChunk] = []
        self._clamped = False
        self._held = 0  # consecutive fully-held flushes
        self.holds = 0  # flushes that held chunks back (observability)
        self.flushes = 0  # bursts actually mailed
        #: optional obs.metrics.MetricsRegistry; None = no-op telemetry
        #: (the no-telemetry path must exist so serve output can be
        #: asserted byte-identical with and without a registry attached)
        self.metrics = metrics
        #: optional obs.spans.SpanTracker + stream_id -> request id map;
        #: a stream's step-0 chunk riding a burst marks the span's
        #: "stream.first_flush" tick (held chunks mark when they SHIP,
        #: not when they queue — the clamp delay is part of the latency)
        self.spans = None
        self.span_ids: Dict[int, int] = {}

    def _counter(self, name: str):
        if self.metrics is None:
            return None
        return self.metrics.counter(name, dst=self.dst,
                                    level=self.list_level)

    @property
    def clamped(self) -> bool:
        """True while the reader-fed latency signal clamps this lane."""
        return self._clamped

    def feedback(self, p95: Optional[float]) -> None:
        """Feed the reader's p95 arrive latency for this lane's QoS class;
        clamps the flush rate while it exceeds ``p95_threshold``.  ``None``
        (no observation yet) never clamps."""
        was = self._clamped
        self._clamped = (
            self.p95_threshold is not None
            and p95 is not None
            and p95 > self.p95_threshold
        )
        if self.metrics is not None:
            if p95 is not None:
                self.metrics.series("stream.lane.feedback_p95",
                                    dst=self.dst,
                                    level=self.list_level).append(p95)
            if self._clamped and not was:
                self._counter("stream.lane.clamp_engaged").add(1)

    def writer(self, stream_id: int) -> StreamWriter:
        return StreamWriter(self, stream_id)

    def flush(self, force: bool = False) -> int:
        """Serialize pending chunks (ONE batched SER launch on the fabric's
        device, ``mailbox.fabric.router.device``) and mail the burst.  A clamped lane trickles its oldest ``clamp_chunks``
        and holds the rest (or holds everything when ``clamp_chunks=0``,
        up to ``max_hold`` consecutive flushes).  Returns the number of
        chunks sent; ``force=True`` bypasses the clamp (the end-of-serve
        drain)."""
        if not self._pending:
            return 0
        held_before = self.holds
        if self._clamped and not force:
            if self.clamp_chunks <= 0:  # full hold, bounded by max_hold
                if self._held < self.max_hold:
                    self._held += 1
                    self.holds += 1
                    self._note_flush(0, held_before)
                    return 0
                chunks, self._pending = self._pending, []
            else:  # trickle: oldest chunks ride, the rest wait
                chunks = self._pending[: self.clamp_chunks]
                self._pending = self._pending[self.clamp_chunks:]
                if self._pending:
                    self.holds += 1
        else:
            chunks, self._pending = self._pending, []
        self._held = 0
        dev = self.mailbox.fabric.router.device
        if self.plan is None:
            wire = encode_chunk_burst(chunks, dev)
        else:
            wire = encode_fragment_burst(self.plan, chunks, dev)
        self.mailbox.send(self.dst, wire, list_level=self.list_level)
        self.flushes += 1
        if self.spans is not None:
            for c in chunks:
                if c.step == 0 and c.stream_id in self.span_ids:
                    self.spans.event(self.span_ids[c.stream_id],
                                     "stream.first_flush", dst=self.dst,
                                     level=self.list_level)
        self._note_flush(len(chunks), held_before)
        return len(chunks)

    def _note_flush(self, sent: int, held_before: int) -> None:
        if self.metrics is None:
            return
        if sent:
            self._counter("stream.lane.flushes").add(1)
            self._counter("stream.lane.chunks_sent").add(sent)
        if self.holds > held_before:
            self._counter("stream.lane.holds").add(1)
            self.metrics.gauge("stream.lane.chunks_held", dst=self.dst,
                               level=self.list_level).set(len(self._pending))


@dataclass
class StreamState:
    """Reader-side reassembly state of one (src, stream_id) stream."""

    tokens: List[int] = field(default_factory=list)
    eos: bool = False
    ok: bool = True
    next_step: int = 0
    level: int = 1
    #: router scan step each of this stream's chunks arrived at (one entry
    #: per OBSERVED chunk, in step order) — the per-tick fabric latency
    #: trace that makes time-to-token *jitter* measurable, not just the
    #: mean.  Deliveries that carry no ``arrive_step`` are skipped, never
    #: recorded as 0 (a fake zero-latency sample deflates mean/p95 and
    #: inflates jitter — the signal the backpressure scheduler feeds on).
    arrive_steps: List[int] = field(default_factory=list)


class StreamReader:
    """Demultiplexes chunk bursts into per-stream token sequences.

    ``on_corrupt`` picks the posture toward corrupt DELIVERIES (failed
    CRC32 or unparseable burst):

    * ``"flag"`` (default) — poison exactly the streams whose chunks rode
      in the delivery (``StreamState.ok=False``), the PR-8 behavior;
    * ``"raise"`` — raise ``RuntimeError`` the moment a corrupt delivery
      is fed (stream state untouched by it);
    * ``"retry"`` — skip the corrupt delivery WITHOUT touching stream
      state, so a clean re-delivery (the fabric's ARQ replay, or the
      serve plane's request retry) can land in its place; the skipped
      chunks surface as a step gap only if no replacement ever arrives.

    Stream-level damage the reader itself detects (a step gap or a chunk
    after EOS) always flags the stream — those are reassembly facts, not
    recoverable wire damage.
    """

    def __init__(self, metrics=None, spans=None,
                 on_corrupt: str = "flag",
                 plan: Optional[StreamPlan] = None) -> None:
        if on_corrupt not in ("flag", "raise", "retry"):
            raise ValueError(
                f"on_corrupt must be 'flag', 'raise' or 'retry', got "
                f"{on_corrupt!r}"
            )
        self.on_corrupt = on_corrupt
        #: generated plan bursts are parsed with; None = the token plan
        self.plan = plan
        self.streams: Dict[Tuple[int, int], StreamState] = {}
        #: deliveries whose bursts yielded no parseable chunk at all —
        #: corruption that cannot be attributed to a stream
        self.unattributed: List = []
        #: optional obs.metrics.MetricsRegistry; None = no-op telemetry
        self.metrics = metrics
        #: optional obs.spans.SpanTracker + (src, stream_id) -> request id
        #: map; a stream turning corrupt degrades its request's span with
        #: the reason, an unattributable burst records a tracker anomaly
        self.spans = spans
        self.span_ids: Dict[Tuple[int, int], int] = {}

    def feed(self, deliveries: Iterable) -> List[StreamEvent]:
        """Consume fabric deliveries; returns the fresh stream events."""
        events: List[StreamEvent] = []
        m = self.metrics
        for d in deliveries:
            if self.plan is None:
                chunks, parsed = decode_token_chunks(d.wire)
            else:
                chunks, parsed = decode_fragments(self.plan, d.wire)
            clean = bool(d.ok) and parsed
            if not clean and self.on_corrupt == "raise":
                raise RuntimeError(
                    f"corrupt stream delivery from src {d.src} (level "
                    f"{d.list_level}): CRC failure or unparseable burst — "
                    f"feed with on_corrupt='flag' to inspect"
                )
            if not clean and self.on_corrupt == "retry":
                # drop it whole: a replayed/retried delivery carries the
                # same chunks clean, and folding the damaged copy in now
                # would poison the stream the replacement repairs
                if m is not None:
                    m.counter("stream.reader.skipped_corrupt").add(1)
                continue
            if not chunks:
                if not clean:
                    self.unattributed.append(d)
                    if m is not None:
                        m.counter("stream.reader.unattributed").add(1)
                    if self.spans is not None:
                        self.spans.anomaly(
                            "stream.reader.unattributed", src=d.src,
                            level=d.list_level,
                            request_id=getattr(d, "request_id", None))
                continue
            arrive = getattr(d, "arrive_step", None)
            for c in chunks:
                key = (d.src, c.stream_id)
                st = self.streams.setdefault(key, StreamState())
                st.level = d.list_level
                was_ok = st.ok
                reasons = []
                if not clean:
                    st.ok = False  # CRC/parse failure poisons this stream
                    reasons.append("crc")
                if c.corrupt:
                    # fragment meta violated the plan's declared budgets
                    # (out-of-budget id/step, unknown flags): flag the
                    # stream instead of trusting garbage metadata
                    st.ok = False
                    reasons.append("meta-budget")
                if c.step != st.next_step or st.eos:
                    st.ok = False  # lost, duplicated, or post-EOS chunk
                    reasons.append("chunk-gap")
                if (reasons and self.spans is not None
                        and key in self.span_ids):
                    self.spans.degrade(self.span_ids[key],
                                       ",".join(reasons), src=d.src,
                                       stream_id=c.stream_id, step=c.step)
                st.next_step = c.step + 1
                st.tokens.extend(c.tokens)
                st.eos = st.eos or c.eos
                if m is not None:
                    m.counter("stream.reader.chunks",
                              level=d.list_level).add(1)
                    m.counter("stream.reader.tokens",
                              level=d.list_level).add(len(c.tokens))
                    if was_ok and not st.ok:
                        m.counter("stream.reader.corrupt_streams").add(1)
                    if arrive is not None:
                        m.histogram("stream.reader.arrive_step",
                                    level=d.list_level).observe(arrive)
                if arrive is not None:
                    # a delivery without the field contributes NO latency
                    # sample (recording 0 would claim an impossible
                    # zero-step arrival and drag mean/p95 down)
                    st.arrive_steps.append(arrive)
                events.append(
                    StreamEvent(
                        d.src, c.stream_id, c.step, c.tokens, c.eos, st.ok,
                        arrive,
                    )
                )
        return events

    def arrive_stats(self) -> Dict[str, float]:
        """Aggregate in-fabric latency of every chunk seen so far: the
        router scan step each chunk's carrying message arrived at (see the
        module-level :func:`arrive_stats` for the fields)."""
        return arrive_stats(
            s for st in self.streams.values() for s in st.arrive_steps
        )

    def class_arrive_stats(
        self, window: Optional[int] = None
    ) -> Dict[int, Dict[str, float]]:
        """In-fabric latency per ListLevel (QoS tenant tag): ``{level:
        {n, mean, p95, max, jitter}}``.  This is the reader-side signal the
        backpressure loop feeds into each :class:`ChunkLane` — a lane whose
        level's p95 sits above its threshold clamps its flush rate and
        yields its WRR credits to the other classes.  ``window`` restricts
        each stream to its most recent samples so a clamped tenant can
        *recover* once its tail drains instead of being haunted by old
        congestion forever."""
        per: Dict[int, List[int]] = {}
        for st in self.streams.values():
            tr = st.arrive_steps[-window:] if window else st.arrive_steps
            per.setdefault(st.level, []).extend(tr)
        return {lvl: arrive_stats(tr) for lvl, tr in sorted(per.items())}

    def all_eos(self, expected: Optional[Iterable[Tuple[int, int]]] = None) -> bool:
        """True when every stream (or every ``expected`` key) saw its EOS."""
        if expected is not None:
            return all(
                k in self.streams and self.streams[k].eos for k in expected
            )
        return all(st.eos for st in self.streams.values())
