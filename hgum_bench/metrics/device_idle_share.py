"""Share of a call's wall time in which no kernel, copy or memset ran on the
device: 1 - (busy / wall).  The busy time is the union of the device
intervals of the window's second call, profiled for device activity alone.
The wall is the mean of the same run's unprofiled calls, which do the
same work (every call of a cell holds the same prompt lengths): the
profiler's per-launch records slow a launch-bound host, so the profiled
call's own wall overstates the idle time (by 3-4 % of a call in
mixtral-8x22b, 13-16 % in yi-6b), while its kernels take the same time."""
UNIT = "%"


def read(run):
    p = run.profile
    if p is None or not p.kernels:
        return None
    calls = run.measured_calls()
    wall = sum(c.done - c.sent for c in calls) / len(calls)
    return 100.0 * (1.0 - p.busy_s / wall)
