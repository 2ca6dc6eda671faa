"""The device-trace arithmetic on hand-made events: busy time as a union,
kernels attributed to the host range that launched them, idle gaps named
by what the host was doing."""
from __future__ import annotations

import pytest
import torch

from hgum_bench.devtrace import DeviceTrace, kind_of

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """A stand-in for torch's ``_KinetoEvent`` (the fields the summary reads)."""

    def __init__(self, name, a, b, dev=CPU, corr=0, linked=0, kind=None, ua=False):
        self._v = (name, a, b, dev, corr, linked, ua)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _events(with_kind: bool):
    k = (lambda x: x) if with_kind else (lambda x: None)
    return [
        Ev("hgum.moe_ffn", 100, 400, kind=k("user_annotation"), ua=True),
        Ev("aten::mm", 120, 150, corr=7, kind=k("cpu_op")),
        Ev("cudaLaunchKernel", 125, 140, corr=70, linked=7, kind=k("cuda_runtime")),
        Ev("aten::add", 500, 520, corr=8, kind=k("cpu_op")),
        Ev("hgum.moe_ffn", 110, 390, dev=CUDA, kind=k("gpu_user_annotation"), ua=True),
        Ev("gemm", 200, 300, dev=CUDA, corr=70, linked=7, kind=k("kernel")),
        Ev("gemm2", 250, 350, dev=CUDA, corr=71, linked=7, kind=k("kernel")),
        Ev("add", 600, 700, dev=CUDA, corr=80, linked=8, kind=k("kernel")),
    ]


@pytest.mark.parametrize("with_kind", [True, False])
def test_device_trace(with_kind):
    evs = _events(with_kind)
    assert [kind_of(e) for e in evs] == ["user_annotation", "cpu_op", "cuda_runtime", "cpu_op",
                                         "gpu_user_annotation", "kernel", "kernel", "kernel"]
    t = DeviceTrace(evs, 0, 1000, 1e-6)
    assert t.busy_s == pytest.approx(250e-9)  # [200, 350] and [600, 700]
    assert t.kernel_s() == pytest.approx(300e-9)
    assert t.kernel_s_in("hgum.moe_ffn") == pytest.approx(200e-9)
    assert t.kernel_s_in("hgum.absent") is None
    assert t.device_ops()[0] == ["gemm", pytest.approx(100e-9)]
    gaps = dict((k, v) for k, v in t.idle_gaps())
    # [0, 200] has the range at its middle, [350, 600] the add op, [700, 1000] nothing
    assert gaps == {"hgum.moe_ffn": pytest.approx(200e-9),
                    "host (python)": pytest.approx(550e-9)}
