"""Mean host time to enqueue one decode step: the duration of the
program's ``batcher.decode`` spans (the decode-step call, which returns
before the device finishes; no sync) in the window's unprofiled calls.
Set against ``decode_step_ms``: the host leads where this is the larger."""
from hgum_bench import programtrace

UNIT = "ms"
install = programtrace.install


def read(run):
    d = [e["dur"] for e in programtrace.spans(run, "batcher.decode")]
    return sum(d) / len(d) / 1e3 if d else None
