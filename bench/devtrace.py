"""The traced run's device timeline: ``torch.profiler`` over a window,
reduced to device operations on the host's clock.

Every operation the card ran (kernels, copies, sets) comes back as
``(name, start, seconds)`` with ``start`` on ``time.perf_counter``'s clock,
placed by an anchor event recorded at a known host time, so that the readers
can match device work to jobs and to host spans.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Op = Tuple[str, float, float]          # name, start (host clock), seconds


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union_seconds(ops: List[Op], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which at least one op ran."""
    busy, end = 0.0, lo
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        a, b = max(s, end), min(s + d, hi)
        if b > a:
            busy += b - a
        end = max(end, min(s + d, hi))
    return busy


def idle_gaps(ops: List[Op], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The (start, end) intervals of [lo, hi] in which no op ran."""
    gaps, end = [], lo
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, s + d)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


@dataclass
class DeviceTimeline:
    t0: float
    t1: float
    ops: List[Op] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self, lo: Optional[float] = None,
               hi: Optional[float] = None) -> float:
        return union_seconds(self.ops, self.t0 if lo is None else lo,
                             self.t1 if hi is None else hi)

    def kernel_seconds(self, lo: float, hi: float) -> float:
        """Summed device time of the kernels that started in [lo, hi)."""
        return sum(d for n, s, d in self.ops if is_kernel(n) and lo <= s < hi)

    def top_ops(self, n: int = 10) -> List[List]:
        by: dict = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0.0) + d
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]


class DeviceTrace:
    """Start with ``start()``, end with ``stop()`` -> :class:`DeviceTimeline`."""

    def __init__(self):
        self._prof = None
        self._anchors: List[Tuple[float, float]] = []
        self._t0 = 0.0

    def start(self) -> None:
        import warnings

        from torch.profiler import ProfilerActivity, profile, record_function

        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        for _ in range(3):
            a = time.perf_counter()
            with record_function("bench.anchor"):
                pass
            self._anchors.append((a, time.perf_counter()))
        self._t0 = time.perf_counter()

    def stop(self) -> DeviceTimeline:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self._prof.stop()
        events = self._prof.events()
        anchors = [e for e in events if e.name == "bench.anchor"]
        # the shortest anchor pins the clocks best: its host bracket and its
        # profiler interval hold the same instant
        best = min(range(len(anchors)),
                   key=lambda i: self._anchors[i][1] - self._anchors[i][0])
        host_mid = sum(self._anchors[best]) / 2
        ev = anchors[best].time_range
        offset = host_mid - (ev.start + ev.end) / 2e6
        ops = [(e.name, e.time_range.start / 1e6 + offset,
                (e.time_range.end - e.time_range.start) / 1e6)
               for e in events if e.device_type == DeviceType.CUDA]
        return DeviceTimeline(self._t0, t1,
                              [o for o in ops if o[1] + o[2] > self._t0])
