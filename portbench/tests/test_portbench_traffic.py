"""The traffic generators: the same seed gives the same schedule, and every
seed the same lengths and gaps in another order."""

import numpy as np
import pytest

from portbench.lib import lengths as Ln
from portbench.lib import spec

BIG = 2**31 + 987_654_321          # seeds past 32 signed bits


def _open(mix_name, seed, seconds=30.0):
    mix = spec.mix(mix_name)
    return spec.module("traffic", "open").schedule(mix, 1000, seed, seconds)


@pytest.mark.parametrize("mix_name", ["chat", "shared-prefix"])
def test_open_same_seed_same_schedule(mix_name):
    a, b = _open(mix_name, BIG), _open(mix_name, BIG)
    assert len(a["requests"]) == len(b["requests"])
    for x, y in zip(a["requests"], b["requests"]):
        assert x["due"] == y["due"] and x["max_new"] == y["max_new"]
        assert x["group"] == y["group"]
        np.testing.assert_array_equal(x["prompt"], y["prompt"])


@pytest.mark.parametrize("mix_name", ["chat", "shared-prefix"])
def test_open_seeds_share_the_schedule(mix_name):
    """Every seed serves the same lengths at the same times (the mix's
    order); the seed draws the token ids."""
    a, b = _open(mix_name, 1), _open(mix_name, BIG)
    assert [r["due"] for r in a["requests"]] == \
        [r["due"] for r in b["requests"]]
    assert [len(r["prompt"]) for r in a["requests"]] == \
        [len(r["prompt"]) for r in b["requests"]]
    assert [r["max_new"] for r in a["requests"]] == \
        [r["max_new"] for r in b["requests"]]
    assert [r["group"] for r in a["requests"]] == \
        [r["group"] for r in b["requests"]]
    assert any((x["prompt"] != y["prompt"]).any()
               for x, y in zip(a["requests"], b["requests"]))


def test_open_lengths_and_gaps_are_the_stratified_sets():
    mix = spec.mix("chat")
    reqs = _open("chat", 4)["requests"]
    n = len(reqs)
    assert sorted(len(r["prompt"]) for r in reqs) == \
        list(Ln.length_set(mix["prompt"], n))
    gaps = np.diff([r["due"] for r in reqs])
    want = Ln.exponential_gaps(mix["rate_rps"], n)
    assert abs(gaps.sum() - (want.sum() - want[0])) < want.max()


def test_open_rate_and_clipping():
    mix = spec.mix("chat")
    reqs = _open("chat", 5)["requests"]
    assert len(reqs) == int(np.ceil(mix["rate_rps"] * (mix["lead_in_s"] + 30)))
    dues = [r["due"] for r in reqs]
    assert dues == sorted(dues) and dues[0] == 0.0
    lens = [len(r["prompt"]) for r in reqs]
    assert min(lens) >= mix["prompt"]["min"]
    assert max(lens) <= mix["prompt"]["max"]
    outs = [r["max_new"] for r in reqs]
    assert mix["output"]["min"] <= min(outs) <= max(outs) \
        <= mix["output"]["max"]


def test_shared_prefix_requests_start_with_their_prompt():
    mix = spec.mix("shared-prefix")
    reqs = _open("shared-prefix", 9)["requests"]
    by = {}
    for r in reqs:
        assert r["group"] >= 0
        by.setdefault(r["group"], []).append(r["prompt"])
    counts = Ln.zipf_counts(len(reqs), mix["prefixes"]["count"],
                            mix["prefixes"]["zipf_s"])
    assert sorted(len(v) for v in by.values()) == sorted(c for c in counts
                                                         if c)
    for g, prompts in by.items():
        plen = min(len(p) for p in prompts) - mix["prompt"]["max"]
        first = prompts[0]
        for p in prompts[1:]:
            n = 0
            while n < min(len(p), len(first)) and p[n] == first[n]:
                n += 1
            assert n >= mix["prefixes"]["min"] or n >= plen


def test_zipf_counts_sum_and_order():
    c = Ln.zipf_counts(1000, 8, 1.0)
    assert c.sum() == 1000
    assert list(c) == sorted(c, reverse=True)


@pytest.mark.parametrize("mix_name,key", [
    ("chat", "prompt"), ("chat", "output"),
    ("shared-prefix", "prompt"), ("shared-prefix", "output")])
def test_sigma_derived_from_the_stated_range(mix_name, key):
    """No shipped mix states a spread of its own: it comes from the stated
    range, ``min`` and ``max`` as the 2.5th and 97.5th percentiles about
    the median, the least-squares fit in log space."""
    dist = spec.mix(mix_name)[key]
    assert "sigma" not in dist
    s = Ln.sigma(dist)
    z = 1.959963984540054
    assert s == pytest.approx(np.log(dist["max"] / dist["min"]) / (2 * z))
    lo, hi = dist["median"] * np.exp(-z * s), dist["median"] * np.exp(z * s)
    # the fit's residuals in log space are equal and opposite
    r_hi, r_lo = np.log(dist["max"] / hi), np.log(lo / dist["min"])
    assert r_hi == pytest.approx(-r_lo)
    assert Ln.quantile(dist, 0.975) == pytest.approx(hi)


def test_a_published_sigma_is_used_as_given():
    assert Ln.sigma(dict(dist="lognormal", median=10, sigma=0.3, min=1,
                         max=1000)) == 0.3
