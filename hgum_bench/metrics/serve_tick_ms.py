"""Mean duration of the streaming plane's compute ticks: the ``serve.tick``
trace events (host clock) of the window's unprofiled calls."""
UNIT = "ms"


def read(run):
    d = [e["dur"] for c in run.measured_calls() if c.obs_trace is not None
         for e in c.obs_trace.events if e.get("name") == "serve.tick"]
    return sum(d) / len(d) / 1e3 if d else None
