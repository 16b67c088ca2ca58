"""Spreads of two sets of runs of a cell (``sets.py``'s JSON lines), by
metric: each set's interquartile range over its median
(``statistics.quantiles(values, n=4)``), the wider of the two, five times
it (the bound it suggests, never under 1 %), and the two medians' gap.

    python3 portbench/tools/spread.py set1.jsonl set2.jsonl
"""

from __future__ import annotations

import json
import statistics
import sys


def load(path):
    rows = [json.loads(l) for l in open(path) if l.strip()]
    return [r for r in rows if r["result"] and r["trace"] == 0]


def spread(v):
    q1, m, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / m


def trimmed(v):
    """The set without its run farthest from the median."""
    m = statistics.median(v)
    far = max(range(len(v)), key=lambda i: abs(v[i] - m))
    return v[:far] + v[far + 1:]


def main() -> None:
    sets = [load(p) for p in sys.argv[1:3]]
    names = sorted({k for s in sets for r in s for k in r["result"]["metrics"]})
    for n in names:
        vals = [[r["result"]["metrics"][n]["value"] for r in s] for s in sets]
        sp = [spread(v) for v in vals]
        tight = statistics.mean(spread(trimmed(v)) for v in vals)
        med = [statistics.median(v) for v in vals]
        print(json.dumps(dict(
            metric=n, values=vals, spreads=sp, widest=max(sp),
            bound_5x=max(0.01, 5 * max(sp)), tight_spread=tight,
            medians=med, median_gap=(med[1] - med[0]) / med[0])))


if __name__ == "__main__":
    main()
