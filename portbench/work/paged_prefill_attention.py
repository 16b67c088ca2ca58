"""``paged_prefill_attention``: a continuation chunk (after a prefix-cache
hit) attending causally over the cache and itself through the page
table.  ``n`` tokens from position ``s``, in each layer: ``4 * Hq * hd``
FLOPs a (query, key) pair, ``n s + n (n + 1) / 2`` pairs; the ``s + n``
cached K and V read once, the queries read and the output written once."""

from __future__ import annotations

from portbench.work.transformer import causal_keys

KERNELS = ("paged_prefill_wgmma_kernel", "paged_prefill_kernel")
STEPS = ("prefill",)
ELEM = 2


def work(dims: dict, steps) -> tuple[float, float]:
    hq = dims["heads"] * dims["head_dim"]
    hkv = dims["kv_heads"] * dims["head_dim"]
    flops = nbytes = 0.0
    for st in steps:
        for start, n in st["chunks"]:
            if not start:
                continue
            flops += 4 * hq * causal_keys(start, n) * dims["layers"]
            nbytes += ELEM * dims["layers"] * (2 * hq * n
                                               + 2 * hkv * (start + n))
    return flops, nbytes
