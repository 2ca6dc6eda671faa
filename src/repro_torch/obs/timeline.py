"""Program spans and counters on a :class:`~.trace.TraceRecorder`'s clock.

The serving planes, the batcher and the model call these at the sites
where their work happens:

* :func:`span` ``(trace, name, *, device=False, parent=None, **args)`` —
  a context manager that writes one Chrome ``X`` event (``cat: "hgum"``)
  on the recorder's clock, with ``args.id`` and ``args.parent`` (the id of
  the enclosing span, so a span's self time is its duration minus its
  children's).  With ``device`` (the ``torch.device`` the work runs on) a
  CUDA event pair brackets the work the span enqueues, and
  :func:`resolve` puts their elapsed time under ``args.device_ms``; on the
  CPU ops run synchronously, so ``device_ms`` is the host duration.  A
  span that opens and closes in two different calls (a batcher tick) uses
  ``begin()`` / ``end()``, and its children name it as ``parent``.
* :func:`count` — a counter.  Device tensors stay on the device until
  :func:`resolve` reads them all in one copy; each count adds to the
  innermost open span's ``args`` and to one ``C`` event per name.
* :func:`mark` / ``interval`` — device time between two points of the
  stream (the idle gap between two ticks).
* :func:`current` — the recorder of the innermost open span in this
  context, for sites inside the model, which take no trace argument (the
  same context-scoped hook as ``runtime.actshard.constrain``).

With ``trace`` None every call returns at once: one ``is None`` test, a
shared no-op context, no CUDA event, no ``record_function``, no copy.
While ``torch.profiler`` records, a span also opens
``record_function("hgum." + name)``, so the profiler's own trace holds the
program's spans; the recorder's ``anchor`` lays ``ts`` onto the
profiler's Unix-epoch clock (:func:`epoch_ns`).

:func:`resolve` runs after the caller's last sync (the serving planes call
it on return), so it waits for nothing.
"""
from __future__ import annotations

import contextvars
import time
from typing import Any, Dict, List

import torch

_current: contextvars.ContextVar = contextvars.ContextVar("hgum_trace", default=None)


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class _NullSpan:
    """The span of ``trace=None``: every method does nothing."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def begin(self) -> "_NullSpan":
        return self

    def end(self) -> None:
        return None

    def interval(self, key: str, start, stop) -> None:
        return None


NULL_SPAN = _NullSpan()


class _State:
    """What a recorder's spans share: ids, the open spans, and the device
    readings that wait for :func:`resolve`."""

    def __init__(self) -> None:
        self.next_id = 0
        self.stack: List["_Span"] = []
        #: (args dict, key, start event, stop event)
        self.intervals: List[tuple] = []
        #: (args dict or None, name, value): values still on the device
        self.counts: List[tuple] = []
        self.totals: Dict[str, float] = {}


def _state(trace) -> _State:
    st = getattr(trace, "_timeline", None)
    if st is None:
        st = trace._timeline = _State()
    return st


def _cuda(device) -> bool:
    return bool(device) and torch.device(device).type == "cuda"


def mark(trace, device):
    """A point on ``device``'s stream: a recorded CUDA event there, or the
    host clock (ns) on the CPU; None without a trace."""
    if trace is None:
        return None
    if _cuda(device):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter_ns()


class _Span:
    __slots__ = ("rec", "st", "name", "device", "parent", "args", "id", "t0",
                 "_ev0", "_rf", "_token")

    def __init__(self, trace, name: str, device, parent, args: Dict[str, Any]):
        self.rec, self.st, self.name = trace, _state(trace), name
        self.device, self.parent, self.args = device, parent, args
        self.id = None
        self._ev0 = self._rf = self._token = None

    def begin(self) -> "_Span":
        st = self.st
        st.next_id += 1
        self.id = st.next_id
        if self.parent is None and st.stack:
            self.parent = st.stack[-1]
        # the event's own args: counts and intervals land here
        self.args = {"id": self.id, "parent": getattr(self.parent, "id", None), **self.args}
        # the span's host interval holds its profiler range and its events
        self.t0 = time.perf_counter_ns()
        if _profiling():
            self._rf = torch.profiler.record_function("hgum." + self.name)
            self._rf.__enter__()
        if _cuda(self.device):
            self._ev0 = mark(self.rec, self.device)
        return self

    def end(self) -> None:
        args = self.args
        if self._ev0 is not None:
            self.st.intervals.append((args, "device_ms", self._ev0, mark(self.rec, self.device)))
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        if self.device and self._ev0 is None:
            args["device_ms"] = (t1 - self.t0) / 1e6
        a0 = self.rec.anchor[0]
        self.rec.complete(self.name, (self.t0 - a0) / 1e3, (t1 - self.t0) / 1e3,
                          cat="hgum", args=args)

    def interval(self, key: str, start, stop) -> None:
        """``args[key]``: ms from ``start`` to ``stop``, two :func:`mark`
        points (skipped when ``start`` is None)."""
        if start is None:
            return
        if isinstance(start, int):
            self.args[key] = (stop - start) / 1e6
        else:
            self.st.intervals.append((self.args, key, start, stop))

    def __enter__(self) -> "_Span":
        self.begin()
        self.st.stack.append(self)
        self._token = _current.set(self.rec)
        return self

    def __exit__(self, *exc) -> None:
        _current.reset(self._token)
        self.st.stack.pop()
        self.end()


def span(trace, name: str, *, device=False, parent=None, **args):
    """A span of ``name`` on ``trace`` (the shared no-op when None); see the
    module docstring."""
    if trace is None:
        return NULL_SPAN
    return _Span(trace, name, device, parent, args)


def current():
    """The recorder of the innermost open span in this context, or None."""
    return _current.get()


def count(trace, name: str, value) -> None:
    """Add ``value`` (a number or a one-element tensor) to counter ``name``."""
    if trace is None:
        return
    st = _state(trace)
    st.counts.append((st.stack[-1].args if st.stack else None, name, value))


def resolve(trace, metrics=None) -> None:
    """Fill the device readings in: ``device_ms`` and intervals from their
    CUDA events, counters from one copy of their device values (each to the
    span it was counted in, and a ``C`` event of the running total per
    name).  ``metrics`` (an ``obs.MetricsRegistry``) gets each counter's
    increment.  Call it after a sync that covers the spans' work."""
    if trace is None:
        return
    st = _state(trace)
    for args, key, e0, e1 in st.intervals:
        args[key] = e0.elapsed_time(e1)
    st.intervals = []
    counts, st.counts = st.counts, []
    dev = [v for _, _, v in counts if isinstance(v, torch.Tensor)]
    # one stack (dtypes promote) and one copy back
    read = iter(torch.stack([v.reshape(()) for v in dev]).tolist() if dev else [])
    added: Dict[str, float] = {}
    for args, name, v in counts:
        v = float(next(read) if isinstance(v, torch.Tensor) else v)
        if args is not None:
            args[name] = args.get(name, 0.0) + v
        added[name] = added.get(name, 0.0) + v
    for name, v in added.items():
        st.totals[name] = st.totals.get(name, 0.0) + v
        trace.counter(name, {"value": st.totals[name]}, cat="hgum")
        if metrics is not None:
            metrics.counter(name).add(v)


def epoch_ns(trace, ts_us: float) -> int:
    """The Unix-epoch ns (``torch.profiler``'s clock) of recorder time
    ``ts_us``."""
    return trace.anchor[1] + int(round(ts_us * 1e3))
