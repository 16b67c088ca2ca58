"""Percentiles over every request, and interval unions.

A request that failed, or had not finished when the drain limit ran out,
has an infinite latency: it stays in the sample, so a tail counts it."""

from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float:
    """Nearest-rank ``p``-th percentile (0 < p <= 100) of ``values``, which
    may hold ``inf``; ``inf`` for an empty sample."""
    xs = sorted(values)
    if not xs:
        return math.inf
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[rank - 1]


def union_length(intervals, lo: float | None = None,
                 hi: float | None = None) -> float:
    """Length of the union of ``(start, end)`` intervals, clipped to
    ``[lo, hi]`` where given.  Overlapping intervals count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle gaps ``(start, end)`` that the union of ``intervals``
    leaves in ``[lo, hi]``, in time order."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else math.inf
