"""``paged_decode_attention``: one query token a lane against its cached
keys.  A decoded token with ``c`` keys, in each layer: ``4 * Hq * hd * c``
FLOPs; its K and V read once (``2 * Hkv * hd * c`` elements), its query
read and its output written once."""

from __future__ import annotations

#: the kernel functions of this family
KERNELS = ("paged_decode_partial", "paged_decode_combine",
           "paged_decode_mma_kernel")
#: the steps whose calls are counted: every step decodes its lanes
STEPS = ("decode", "prefill")
ELEM = 2                                    # bf16 bytes


def work(dims: dict, steps) -> tuple[float, float]:
    hq = dims["heads"] * dims["head_dim"]
    hkv = dims["kv_heads"] * dims["head_dim"]
    keys = sum(sum(st["decode"]) for st in steps)
    toks = sum(len(st["decode"]) for st in steps)
    flops = 4 * hq * keys * dims["layers"]
    nbytes = ELEM * dims["layers"] * (2 * hkv * keys + 2 * hq * toks)
    return flops, nbytes
