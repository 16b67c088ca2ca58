"""Model FLOPs of the decoder families (dense and MoE) from token counts.

A token's forward costs two FLOPs a multiply-add of every projection it
passes through (q, k, v, o; the FFN, for MoE its router and its ``k``
experts only), causal attention ``4 * Hq * hd`` a key it attends to in
each layer, and the output head only where logits are needed: once a
prefill chunk (its last token) and once a decoded token."""

from __future__ import annotations


def linear_per_token(dims: dict) -> float:
    d, hd = dims["d"], dims["head_dim"]
    hq, hkv = dims["heads"] * hd, dims["kv_heads"] * hd
    attn = 2 * d * (hq + 2 * hkv) + 2 * hq * d
    if dims["experts"]:
        ffn = 2 * 3 * d * dims["ffn"] * dims["top_k"] + 2 * d * dims["experts"]
    else:
        ffn = 2 * 3 * d * dims["ffn"]
    return dims["layers"] * (attn + ffn)


def head(dims: dict) -> float:
    return 2 * dims["d"] * dims["vocab"]


def attn_per_key(dims: dict) -> float:
    """FLOPs of one query against one key, over all layers (QK and PV)."""
    return 4 * dims["heads"] * dims["head_dim"] * dims["layers"]


def causal_keys(start: int, n: int) -> int:
    """Keys attended by ``n`` queries at positions ``start..start+n-1``."""
    return n * start + n * (n + 1) // 2


def step(dims: dict, st: dict) -> float:
    """FLOPs of one engine step's record: its prefill chunks and its
    decoded positions (``decode`` holds each decoded token's key count)."""
    lin, hd_, ak = linear_per_token(dims), head(dims), attn_per_key(dims)
    f = 0.0
    for start, n in st["chunks"]:
        f += n * lin + hd_ + ak * causal_keys(start, n)
    f += len(st["decode"]) * (lin + hd_) + ak * sum(st["decode"])
    return f
