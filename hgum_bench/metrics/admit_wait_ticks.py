"""Mean ticks a streamed request waits from ingress to its admission into a
shard's batch: ``admit_wait`` of ``obs.spans.tick_breakdown`` over every
request span of the window's unprofiled calls."""
UNIT = "ticks"


def read(run):
    from repro_torch.obs.spans import tick_breakdown

    waits = [tick_breakdown(s).get("admit_wait") for c in run.measured_calls()
             if c.spans is not None for s in c.spans.requests()]
    waits = [w for w in waits if w is not None]
    return sum(waits) / len(waits) if waits else None
