"""95th percentile over every prompt stream of the window of the time from
its call's send to its first token at the ingress.  In the chat cell the
tail is the second wave of streams, admitted when the first wave's slots
free, so it moves with the streaming tick.  A stream with no first token
is counted as failed by the check, not here."""
import numpy as np

UNIT = "s"


def read(run):
    v = [times[0] - c.sent for c in run.calls for times in c.token_times.values() if times]
    return float(np.percentile(v, 95)) if v else None
