"""What the device did, from a ``torch.profiler`` trace of one call.

The busy arithmetic is the one of the program's
``scripts/profile_torch_serve.py`` (device activity over host wall time),
copied here and taken over the union of the device intervals, so two
overlapping kernels count once.  The summary also names what the host
was doing in each idle gap: the innermost ``hgum.*`` range (the
benchmark's own ``record_function`` wrappers, traced runs only) around
the gap's middle, else the outermost CPU operator there, else
``host (python)``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def kind_of(e) -> str:
    """The kineto activity of an event: ``activity_type()`` where torch has
    it, else from its device, its annotation flag and its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    import torch

    name = e.name()
    ua = e.is_user_annotation() if hasattr(e, "is_user_annotation") else name.startswith("hgum.")
    if e.device_type() != torch.autograd.DeviceType.CPU:
        return "gpu_user_annotation" if ua else "kernel"
    if ua:
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "cuda_runtime"
    return "cpu_op"


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Device intervals, kernel launches and host ranges of one traced call."""

    def __init__(self, events, t0_ns: int, t1_ns: int, wall_s: float):
        #: (start, end, name, launch ns) of every device interval; a kernel's
        #: launch is the start of the CPU operator it is linked to, else of
        #: its runtime call
        self.kernels: List[Tuple[int, int, str, Optional[int]]] = []
        self.ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        ops: List[Tuple[int, int, str]] = []
        op_start: Dict[int, int] = {}
        rt_start: Dict[int, int] = {}
        device = []
        for e in events:
            kind = kind_of(e)
            if kind in _DEVICE_KINDS:
                device.append(e)
            elif kind in ("cuda_runtime", "cuda_driver"):
                rt_start[e.correlation_id()] = e.start_ns()
            elif kind == "user_annotation" and e.name().startswith("hgum."):
                self.ranges[e.name()].append((e.start_ns(), e.end_ns()))
            elif kind == "cpu_op":
                ops.append((e.start_ns(), e.end_ns(), e.name()))
                op_start[e.correlation_id()] = e.start_ns()
        for e in device:
            t = op_start.get(e.linked_correlation_id(), rt_start.get(e.correlation_id()))
            self.kernels.append((e.start_ns(), e.end_ns(), e.name(), t))
        for v in self.ranges.values():
            v.sort()
        # the outermost CPU operators, disjoint and in order
        self.top_ops: List[Tuple[int, int, str]] = []
        for a, b, name in sorted(ops, key=lambda x: (x[0], -x[1])):
            if not self.top_ops or a >= self.top_ops[-1][1]:
                self.top_ops.append((a, b, name))
        self._top_starts = [a for a, _, _ in self.top_ops]
        self.t0_ns, self.t1_ns, self.wall_s = t0_ns, t1_ns, wall_s
        self.busy = _union([(a, b) for a, b, _, _ in self.kernels])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernel_s(self) -> float:
        return sum(b - a for a, b, _, _ in self.kernels) / 1e9

    def kernel_s_in(self, range_name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside a host range
        (None when the trace holds no such range)."""
        iv = self.ranges.get(range_name)
        if not iv:
            return None
        starts = [a for a, _ in iv]
        tot = 0
        for a, b, _, t in self.kernels:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                tot += b - a
        return tot / 1e9

    def device_ops(self, n: int = 10) -> List[list]:
        acc: Dict[str, int] = defaultdict(int)
        for a, b, name, _ in self.kernels:
            acc[name[:120]] += b - a
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def _host_at(self, t: int) -> str:
        best, width = None, None
        for name, iv in self.ranges.items():
            i = bisect.bisect_right(iv, (t, 1 << 62)) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                w = iv[i][1] - iv[i][0]
                if width is None or w < width:
                    best, width = name, w
        if best is not None:
            return best
        i = bisect.bisect_right(self._top_starts, t) - 1
        if i >= 0 and t <= self.top_ops[i][1]:
            return "op " + self.top_ops[i][2][:100]
        return "host (python)"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle time of the window by what the host was doing, the
        largest ``n`` totals."""
        edges = [self.t0_ns] + [x for iv in self.busy for x in iv] + [self.t1_ns]
        acc: Dict[str, int] = defaultdict(int)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                acc[self._host_at((a + b) // 2)] += b - a
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]
