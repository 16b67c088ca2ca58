"""``flash_attention``: a cold prefill chunk's causal self-attention.  A
chunk of ``n`` tokens from position 0, in each layer: ``4 * Hq * hd *
n (n + 1) / 2`` FLOPs; q, k, v read once and the output written once."""

from __future__ import annotations

from portbench.work.transformer import causal_keys

KERNELS = ("flash_wgmma_kernel", "flash_attention_kernel")
STEPS = ("prefill",)
ELEM = 2


def work(dims: dict, steps) -> tuple[float, float]:
    hq = dims["heads"] * dims["head_dim"]
    hkv = dims["kv_heads"] * dims["head_dim"]
    flops = nbytes = 0.0
    for st in steps:
        for start, n in st["chunks"]:
            if start:
                continue
            flops += 4 * hq * causal_keys(0, n) * dims["layers"]
            nbytes += ELEM * dims["layers"] * n * (2 * hq + 2 * hkv)
    return flops, nbytes
