"""Mean time of one decode-step call: the benchmark wraps the decode step
that ``runtime.scheduler.ContinuousBatcher`` gets from
``launch.steps.cached_serve_steps`` and records a CUDA event before and
after each call, so it adds no host sync and leaves the streaming plane's
overlap as it is.  The time between the two events on the device's
stream is the step's span there: its kernels, and the waits between them
while the host enqueues.  The profiled calls are left out."""
import contextlib
import time
from unittest import mock

import torch

UNIT = "ms"


@contextlib.contextmanager
def install(run):
    import repro_torch.launch.steps as steps

    rec = run.notes.setdefault("decode_steps", [])
    orig = steps.cached_serve_steps
    cuda = run.device.type == "cuda"

    def ranged(fn, label):
        def call(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return call

    def timed(fn):
        def call(*a, **k):
            owner = run.current
            if cuda:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            else:
                t0 = time.perf_counter()
            with torch.profiler.record_function("hgum.decode_step"):
                out = fn(*a, **k)
            if cuda:
                e1.record()
                rec.append((owner, lambda: e0.elapsed_time(e1)))
            else:
                dt = (time.perf_counter() - t0) * 1e3
                rec.append((owner, lambda: dt))
            return out
        return call

    def patched(*a, **k):
        prefill, decode = orig(*a, **k)
        return ranged(prefill, "hgum.prefill_step"), timed(decode)

    with mock.patch.object(steps, "cached_serve_steps", patched):
        yield


def read(run):
    rec = run.notes.get("decode_steps", [])
    kept = [ms for owner, ms in rec if owner is not None and not owner.profiled] or \
        [ms for _, ms in rec]
    return sum(f() for f in kept) / len(kept) if kept else None
