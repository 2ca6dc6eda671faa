"""95th percentile of every gap between successive tokens of one stream at
the ingress, over all streams of the window: the streaming plane's tick
as the client sees it."""
import numpy as np

UNIT = "ms"


def read(run):
    gaps = [g for c in run.calls for t in c.token_times.values() for g in np.diff(t)]
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
