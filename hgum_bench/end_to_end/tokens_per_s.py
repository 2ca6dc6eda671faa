"""Generated tokens delivered over the whole window: every token of every
response of the window's calls (a streamed cell counts them as they reach
the ingress), over the window's seconds."""
UNIT = "tokens/s"


def read(run):
    return sum(c.tokens for c in run.calls) / run.window_s
