"""Percentiles over every request, failures infinite; idle from the union
of overlapping intervals."""

import math

import pytest

from portbench.lib import stats


def test_percentile_counts_failures_as_infinite():
    ok = [float(i) for i in range(1, 100)]           # 99 finished
    assert stats.percentile(ok + [math.inf], 95) == 95.0
    many_failed = ok[:90] + [math.inf] * 10
    assert stats.percentile(many_failed, 95) == math.inf
    assert stats.percentile([], 95) == math.inf


@pytest.mark.parametrize("n,p,want", [(1, 95, 1), (20, 95, 19), (20, 50, 10),
                                      (200, 95, 190), (3, 100, 3)])
def test_percentile_nearest_rank(n, p, want):
    assert stats.percentile(list(range(1, n + 1)), p) == want


def test_union_counts_overlap_once():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.union_length(iv, 0.5, 3.5) == pytest.approx(2.0)
    assert stats.union_length([]) == 0.0


def test_gaps_fill_the_rest_of_the_window():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    g = stats.gaps(iv, 0.0, 7.0)
    assert g == [(0.0, 1.0), (3.0, 5.0), (6.0, 7.0)]
    busy = stats.union_length(iv, 0.0, 7.0)
    assert busy + sum(b - a for a, b in g) == pytest.approx(7.0)


def test_spread_is_interquartile_over_median():
    assert stats.spread([10, 10, 10, 10]) == 0.0
    v = [9.0, 10.0, 10.0, 11.0, 12.0, 8.0]
    q1, m, q3 = __import__("statistics").quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / m)
