"""Length and gap sets for the traffic generators.

Every run gets the same multiset of lengths and inter-arrival gaps: the
``n`` values sit at the quantiles ``(i + 0.5) / n`` of the mix's
distribution, in an order the mix fixes; the seed draws the token ids.
So two seeds run the same work, and the spread between runs is the
system's, not the draw's."""

from __future__ import annotations

import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()
#: the standard normal's 97.5th percentile (1.95996...)
Z_975 = _NORMAL.inv_cdf(0.975)


def sigma(dist: dict) -> float:
    """The log-space spread of a lognormal length distribution: the mix's
    ``sigma`` where a source publishes one.  Without it, the spread is
    derived from the stated median and range alone: ``min`` and ``max``
    taken as the 2.5th and 97.5th percentiles, the least-squares fit in
    log space of ``median * exp(-+z sigma)`` to them, which is
    ``ln(max / min) / (2 z)`` with ``z`` the 97.5th percentile of the
    standard normal."""
    if "sigma" in dist:
        return float(dist["sigma"])
    return math.log(dist["max"] / dist["min"]) / (2 * Z_975)


def quantile(dist: dict, q: float) -> float:
    """The ``q`` quantile of a mix's length distribution, unclipped:
    ``{"dist": "lognormal", "median", "min", "max"}`` (and ``sigma``
    where published; see :func:`sigma`) or ``{"dist": "uniform", "min",
    "max"}``."""
    if dist["dist"] == "lognormal":
        return dist["median"] * math.exp(sigma(dist) * _NORMAL.inv_cdf(q))
    if dist["dist"] == "uniform":
        return dist["min"] + q * (dist["max"] - dist["min"])
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def length_set(dist: dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the stratified quantiles, clipped to
    ``[min, max]``, in ascending order."""
    qs = (np.arange(n) + 0.5) / n
    vals = [round(quantile(dist, float(q))) for q in qs]
    return np.clip(np.array(vals, np.int64), dist["min"], dist["max"])


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` Poisson inter-arrival gaps (seconds) at the stratified
    quantiles of Exp(rate), ascending; their sum is ``~n / rate``."""
    qs = (np.arange(n) + 0.5) / n
    return -np.log1p(-qs) / rate


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use (``stream``) of a run's
    seed; any non-negative integer seed, however large."""
    return np.random.default_rng([int(seed), int(stream)])


def zipf_counts(n: int, k: int, s: float) -> np.ndarray:
    """How many of ``n`` requests go to each of ``k`` items under Zipf(s)
    popularity (item ``i`` has weight ``1 / (i + 1) ** s``), apportioned by
    largest remainder so the counts sum to ``n``."""
    w = 1.0 / np.arange(1, k + 1) ** s
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[: n - counts.sum()]] += 1
    return counts
