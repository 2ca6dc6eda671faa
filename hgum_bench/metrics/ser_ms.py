"""Mean host time of the bulk SER, one per call: the program's
``serve.ser`` span (``launch.serve.encode_response_batch``) in the
window's unprofiled calls."""
from hgum_bench import programtrace

UNIT = "ms"
install = programtrace.install


def read(run):
    d = [e["dur"] for e in programtrace.spans(run, "serve.ser")]
    return sum(d) / len(d) / 1e3 if d else None
