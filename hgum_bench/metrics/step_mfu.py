"""The whole step's share of the chip's bf16 peak: model FLOPs of the useful
work the calls completed (``flops.sequence_flops``: prompts without
padding, generated tokens, attention at its true context) over their
seconds times 989e12 (NVIDIA H100 SXM, dense bf16, 700 W).  The profiled
calls are left out."""
from hgum_bench.flops import PEAK_BF16_FLOPS

UNIT = "%"


def read(run):
    if run.device.type != "cuda":
        return None
    calls = run.measured_calls()
    secs = sum(c.done - c.sent for c in calls)
    return 100.0 * sum(c.useful_flops for c in calls) / (secs * PEAK_BF16_FLOPS)
