"""A bounded span of work under ``torch.profiler``, reduced in memory.

The span runs inside one ``record_function('bench.span')`` range, between
two device synchronisations.  From the profiler's raw records (no Chrome
trace is written) it keeps the device's records (kernels, copies, sets;
not the device's copies of the benchmark's ranges), and the benchmark's
own host ranges (``bench.*``) with the host operators, so that an idle gap
can be named by what the host was doing.  The arithmetic over
the device categories is ``utils/profiling.py``'s (the port's), done here
on the events in memory.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import Callable, List, Optional, Tuple

Interval = Tuple[str, int, int]  # name, start ns, end ns


class Trace:
    """The device's activity and the host's ranges over one span."""

    def __init__(self, device: List[Interval], host: List[Interval], ops: List[Interval],
                 start: int, end: int):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host
        # the outermost host operators, disjoint and in time order
        self.ops: List[Interval] = []
        for op in sorted(ops, key=lambda e: (e[1], -e[2])):
            if not self.ops or op[1] >= self.ops[-1][2]:
                self.ops.append(op)
        self._op_starts = [op[1] for op in self.ops]
        self.start, self.end = start, end

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity inside the span, as disjoint
        intervals in time order."""
        out: List[List[int]] = []
        for _, a, b in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Seconds and count of the device records whose name ``match``es."""
        hits = [(b - a) for name, a, b in self.device if match(name)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Counter = Counter()
        for name, a, b in self.device:
            tot[name] += (b - a) / 1e9
        return [[name, s] for name, s in tot.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time inside the span, summed by what the host
        was doing at each gap's middle: the innermost ``bench.*`` range and
        the outermost host operator there, the largest first."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        tot: Counter = Counter()
        for a, b in gaps:
            mid = (a + b) // 2
            tot[self._host_at(mid)] += (b - a) / 1e9
        return [[name, s] for name, s in tot.most_common(n)]

    def _host_at(self, t: int) -> str:
        ranges = [e for e in self.host if e[1] <= t < e[2]]
        where = min(ranges, key=lambda e: e[2] - e[1])[0] if ranges else "outside bench ranges"
        i = bisect.bisect_right(self._op_starts, t) - 1
        op = self.ops[i][0] if i >= 0 and t < self.ops[i][2] else None
        return f"{where} / {op}" if op else where


def record(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """Run ``fn()`` under the profiler between synchronisations; returns its
    result and the reduced trace of the span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function("bench.span"):
            out = fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    span: Optional[Interval] = None
    host, ops, on_device = [], [], []
    for e in events:
        start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
        item = (e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            on_device.append(item)
        elif e.name() == "bench.span":
            span = item
        elif e.name().startswith("bench."):
            host.append(item)
        else:
            ops.append(item)
    # the device's own records of the host's ranges are no device work
    ranges = {h[0] for h in host} | {"bench.span"}
    device = [d for d in on_device if d[0] not in ranges]
    if span is None:
        raise RuntimeError("the profiler recorded no bench.span range")
    return out, Trace(device, host, ops, span[1], span[2])
