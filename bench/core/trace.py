"""What the device did in a traced window, from ``torch.profiler``.

``Trace.read(prof, window_s)`` keeps every device activity (kernels,
copies, sets) as an interval, and the host's ATen ops for naming idle
gaps.  Busy time is the length of the union of the device intervals;
``kernel_seconds(pattern)`` sums the device time of the kernels whose
name matches.
"""

from __future__ import annotations

import collections
import dataclasses
import re

import torch


@dataclasses.dataclass
class Trace:
    window_s: float
    device: list            # (start_ns, end_ns, name), sorted
    host: list              # (start_ns, end_ns, name), sorted

    @classmethod
    def read(cls, prof, window_s: float) -> "Trace":
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            span = (start, start + e.duration_ns(), e.name())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append(span)
            elif e.name().startswith("aten::"):
                host.append(span)
        return cls(window_s, sorted(dev), sorted(host))

    def busy_s(self) -> float:
        total, end = 0, None
        for s, e, _ in self.device:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return 1e-9 * sum(e - s for s, e, n in self.device if rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for s, e, name in self.device:
            by[name] += e - s
        return [[name, ns * 1e-9] for name, ns in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps between device activity, each named by the
        shortest ATen op the host was inside when it began."""
        gaps, end = [], None
        for s, e, _ in self.device:
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        out = []
        for length, at in sorted(gaps, reverse=True)[:n]:
            inside = [(e - s, name) for s, e, name in self.host
                      if s <= at < e]
            out.append([min(inside)[1] if inside else "host (no ATen op)",
                        length * 1e-9])
        return out
