"""Share of a traced call's kernel time launched inside the MoE layer: the
benchmark wraps ``models.ffn.moe_ffn`` (called from
``models.model.layer_forward``) in a ``record_function`` range, and
counts the kernels whose launching operator starts inside it, in the
window's third call, profiled with the host's operators."""
import contextlib
from unittest import mock

import torch

UNIT = "%"


@contextlib.contextmanager
def install(run):
    import repro_torch.models.ffn as ffn

    orig = ffn.moe_ffn

    def moe_ffn(*a, **k):
        with torch.profiler.record_function("hgum.moe_ffn"):
            return orig(*a, **k)

    with mock.patch.object(ffn, "moe_ffn", moe_ffn):
        yield


def read(run):
    p = run.host_profile
    if p is None or not p.kernels:
        return None
    inside = p.kernel_s_in("hgum.moe_ffn")
    return None if inside is None else 100.0 * inside / p.kernel_s()
