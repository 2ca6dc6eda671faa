"""Mean device time of one admit prefill: ``device_ms`` of the program's
``batcher.prefill`` spans (CUDA events around the prefill step and the
slot copies) in the window's unprofiled calls."""
from hgum_bench import programtrace

UNIT = "ms"
install = programtrace.install


def read(run):
    d = [e["args"]["device_ms"] for e in programtrace.spans(run, "batcher.prefill")
         if "device_ms" in e.get("args", {})]
    return sum(d) / len(d) if d else None
