"""The program's own timeline of each batched call, for the metrics that
read it.

``install(run)`` wraps ``repro_torch.launch.serve.serve_requests`` once a
run (every reader that needs it enters it; the first wraps, the others
find it done) and hands each call a fresh ``repro_torch.obs.TraceRecorder``,
kept on ``run.current.obs_trace``.  The program fills it with its
``obs.timeline`` spans (``serve.des``, ``batcher.tick``,
``batcher.prefill``, ``batcher.decode``, ``serve.ser``, ...) and reads
their CUDA events before it returns.  A program whose ``serve_requests``
takes no ``trace`` is left as it is, and the readers find nothing.

``spans(run, name)`` gives the complete events of that name in the
window's unprofiled calls.
"""
from __future__ import annotations

import contextlib
import inspect
from unittest import mock

_KEY = "programtrace"


@contextlib.contextmanager
def install(run):
    import repro_torch.launch.serve as serve

    orig = serve.serve_requests
    if run.notes.get(_KEY) or "trace" not in inspect.signature(orig).parameters:
        yield
        return
    from repro_torch.obs import TraceRecorder

    def traced(*a, **k):
        rec = TraceRecorder()
        if run.current is not None:
            run.current.obs_trace = rec
        return orig(*a, trace=rec, **k)

    run.notes[_KEY] = True
    try:
        with mock.patch.object(serve, "serve_requests", traced):
            yield
    finally:
        run.notes.pop(_KEY, None)


def spans(run, name: str) -> list:
    return [e for c in run.measured_calls() if c.obs_trace is not None
            for e in c.obs_trace.events if e.get("ph") == "X" and e.get("name") == name]
