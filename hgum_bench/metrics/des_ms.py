"""Mean host time of the batched DES, one per call: the program's
``serve.des`` span (``core.vectorized.batch_plans``, B1-B3 and the
readback) in the window's unprofiled calls."""
from hgum_bench import programtrace

UNIT = "ms"
install = programtrace.install


def read(run):
    d = [e["dur"] for e in programtrace.spans(run, "serve.des")]
    return sum(d) / len(d) / 1e3 if d else None
