"""Open-loop traffic: Poisson arrivals at the mix's fixed rate, whatever
the system does.  Each request is due at its scheduled time, and its
latency is counted from then.  ``run`` drives a cell of this kind
(``lib/serve.py``'s open loop); each traffic kind's module has its own.

Mix keys (``traffic/<mix>.json`` with ``"kind": "open"``):

- ``rate_rps``: arrivals a second;
- ``lead_in_s``: traffic before the window opens (not counted), so the
  window opens on a loaded engine;
- ``drain_s``: after the window, how long the run keeps stepping for the
  requests due in it; one still unfinished counts as missing;
- ``prompt`` / ``output``: length distributions (``lib/lengths.py``);
  with ``prefixes``, ``prompt`` is the unique part after the prefix;
- ``prefixes`` (optional): ``{"count", "min", "max", "zipf_s"}``: each
  request starts with one of ``count`` shared prompts whose lengths are
  spread evenly over ``[min, max]``, drawn by Zipf(``zipf_s``);
- ``warmup``: ``[[prompt_len, output_len], ...]`` run before the traffic,
  in two waves (the second after one engine step, so that with prefixes it
  hits the first wave's resident pages);
- ``trace_slice_s``: the traced run profiles this much of the window's
  middle;
- ``schedule_seed``: orders the lengths, gaps and shared prompts.  The
  order is the mix's, the same for every run: the run's seed draws the
  token ids (and the weights).  Orders drawn from the run's seed made
  the TTFT tail swing by seed (which long prompts arrive together), far
  more than two runs of one seed differ.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.lib import lengths as Ln


def run(ctx) -> dict:
    """One run of an open-loop cell."""
    from portbench.lib import serve
    return serve.run(ctx, serve.open_loop)


def _prefix_lengths(spec: dict) -> np.ndarray:
    """The shared prompts' lengths, evenly spread, in a fixed order of
    popularity (the same for every seed): a fixed shuffle, so the most
    popular prompt is neither the shortest nor the longest."""
    ls = np.linspace(spec["min"], spec["max"], spec["count"]).round()
    order = np.random.default_rng(0).permutation(spec["count"])
    return ls.astype(np.int64)[order]


def schedule(mix: dict, vocab: int, seed: int, seconds: float) -> dict:
    """The run's requests: ``due`` (seconds after the traffic starts),
    ``prompt`` (int32 ids), ``max_new`` and ``group`` (the shared prompt's
    index, -1 without)."""
    horizon = mix["lead_in_s"] + seconds
    n = math.ceil(mix["rate_rps"] * horizon)
    order = Ln.rng(mix["schedule_seed"], 0)
    gaps = order.permutation(Ln.exponential_gaps(mix["rate_rps"], n))
    due = np.cumsum(gaps) - gaps[0]
    plen = order.permutation(Ln.length_set(mix["prompt"], n))
    olen = order.permutation(Ln.length_set(mix["output"], n))
    toks = Ln.rng(seed, 1)
    pre = mix.get("prefixes")
    if pre:
        prefixes = [toks.integers(0, vocab, int(m), dtype=np.int32)
                    for m in _prefix_lengths(pre)]
        counts = Ln.zipf_counts(n, pre["count"], pre["zipf_s"])
        group = order.permutation(np.repeat(np.arange(pre["count"]), counts))
    else:
        group = np.full(n, -1)
    reqs = []
    for i in range(n):
        user = toks.integers(0, vocab, int(plen[i]), dtype=np.int32)
        g = int(group[i])
        prompt = np.concatenate([prefixes[g], user]) if g >= 0 else user
        reqs.append(dict(due=float(due[i]), prompt=prompt,
                         max_new=int(olen[i]), group=g))
    return dict(requests=reqs, warmup=warmup(mix, vocab, seed),
                lead_in=float(mix["lead_in_s"]), drain=float(mix["drain_s"]))


def warmup(mix: dict, vocab: int, seed: int) -> list[list[dict]]:
    """Two waves of requests in the mix's length range; with prefixes the
    second wave repeats the first wave's prefixes with other user parts,
    so it runs the continuation path."""
    toks = Ln.rng(seed, 2)
    pre = mix.get("prefixes")
    waves = [[], []]
    prefixes = {}
    for i, (p, o) in enumerate(mix["warmup"]):
        wave = waves[i % 2]
        if pre:
            key = i // 2
            if key not in prefixes:
                prefixes[key] = toks.integers(0, vocab, pre["max"],
                                              dtype=np.int32)
            prompt = np.concatenate([prefixes[key], toks.integers(
                0, vocab, p, dtype=np.int32)])
        else:
            prompt = toks.integers(0, vocab, p, dtype=np.int32)
        wave.append(dict(due=0.0, prompt=prompt, max_new=int(o), group=-1))
    return waves
