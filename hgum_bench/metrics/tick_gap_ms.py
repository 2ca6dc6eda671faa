"""Mean device idle between two consecutive scheduler ticks: ``gap_ms`` of
the program's ``batcher.tick`` spans, the time between a CUDA event after
one tick's last enqueued work and one before the next tick's first
enqueue, in the window's unprofiled calls."""
from hgum_bench import programtrace

UNIT = "ms"
install = programtrace.install


def read(run):
    d = [e["args"]["gap_ms"] for e in programtrace.spans(run, "batcher.tick")
         if "gap_ms" in e.get("args", {})]
    return sum(d) / len(d) if d else None
