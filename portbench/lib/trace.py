"""The traced run's device trace: ``torch.profiler`` over a slice of the
window, reduced to a summary in memory (nothing of the trace is written
to disk).

The slice starts and ends between engine steps, each of which ends in a
host sync, so every kernel of the steps inside it is in the trace and no
kernel of a step outside it.  A marker kernel launched right after the
profiler starts, on an idle device, ties the trace's clock to the host's:
``host = h0 + (t - t_marker)``.

Kernel names map to families by the patterns the ``work/`` modules give;
a family's device time is the union of its kernels' intervals, and the
device's busy time the union of all device intervals, so kernels that
overlap (programmatic dependent launch) count once."""

from __future__ import annotations

import bisect
import collections
import math
import time

import torch

from portbench.lib import stats


class DeviceSlice:
    """One profiled slice: :meth:`start`, steps, :meth:`stop`."""

    def __init__(self):
        self.events: list[tuple[str, float, float]] = []   # host s
        self.h0 = self.h1 = None
        self._prof = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once in set-up, so that its first
        start (CUPTI's initialisation) does not fall in the window."""
        s = DeviceSlice()
        s.start()
        s.stop()

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.h0 = time.perf_counter()
        torch.cuda._sleep(1000)                     # the marker kernel

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.h1 = time.perf_counter()
        self._prof.stop()
        raw = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = ev.start_ns()
            raw.append((ev.name(), s, s + ev.duration_ns()))
        self._prof = None
        if not raw:
            raise RuntimeError("the profiler recorded no device operation")
        raw.sort(key=lambda e: e[1])
        t_mark = raw[0][1]
        self.events = [(n, self.h0 + (s - t_mark) * 1e-9,
                        self.h0 + (e - t_mark) * 1e-9) for n, s, e in raw[1:]]

    @property
    def window_s(self) -> float:
        return self.h1 - self.h0

    def busy_s(self) -> float:
        return stats.union_length([(s, e) for _, s, e in self.events],
                                  self.h0, self.h1)

    def family_s(self, patterns, intervals=None) -> float | None:
        """Device seconds of the kernels whose name holds one of
        ``patterns`` (only those whose midpoint falls in one of the host
        ``intervals``, where given); None when no such kernel ran."""
        iv = [(s, e) for n, s, e in self.events
              if any(p in n for p in patterns)]
        if intervals is not None:
            iv = [(s, e) for s, e in iv if _inside((s + e) / 2, intervals)]
        if not iv:
            return None
        return stats.union_length(iv, self.h0, self.h1)

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for n, s, e in self.events:
            by[n[:160]] += e - s
        return [[n, v] for n, v in by.most_common(top)]

    def idle_gaps(self, spans, top: int = 10) -> list:
        """The idle seconds in the slice, summed by what the host was doing
        (``spans``: ``(label, t0, t1)`` in host seconds, in time order; a
        gap's label is the span holding its start, else "host: loop")."""
        by = collections.Counter()
        gaps = stats.gaps([(s, e) for _, s, e in self.events],
                          self.h0, self.h1)
        i = 0
        for g0, g1 in gaps:
            while i < len(spans) and spans[i][2] <= g0:
                i += 1
            label = "host: loop"
            if i < len(spans) and spans[i][1] <= g0:
                label = spans[i][0]
            by[label] += g1 - g0
        return [[n, v] for n, v in by.most_common(top)]


def _inside(t: float, intervals) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``intervals``."""
    i = bisect.bisect_right(intervals, (t, math.inf)) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]
