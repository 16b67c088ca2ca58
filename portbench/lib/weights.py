"""Random weights made on the device from the seed, in the dtype they are
served in, one ``randn`` call a leaf kind for all layers at once; the
per-layer leaves are views of the stacked tensors.

The tree has the layout the port takes (``params["blocks"][i]["attn"]
["wq"]``, weights ``[in, out]`` applied as ``x @ W``), and the plain
reference reads the same tensors: both sides get the benchmark's inputs,
neither gets anything the other made.

Distributions: dense weights N(0, 1/fan_in), the embedding N(0, 0.02^2),
biases N(0, 0.02^2), norm scales 1, the MoE router in float32."""

from __future__ import annotations

import torch


def make(dims: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n, d = dims["layers"], dims["d"]
    hq = dims["heads"] * dims["head_dim"]
    hkv = dims["kv_heads"] * dims["head_dim"]

    def normal(shape, std, dt=dtype):
        t = torch.randn(shape, generator=gen, dtype=dt, device=device)
        return t.mul_(std)

    stack = {
        "wq": normal((n, d, hq), d ** -0.5),
        "wk": normal((n, d, hkv), d ** -0.5),
        "wv": normal((n, d, hkv), d ** -0.5),
        "wo": normal((n, hq, d), hq ** -0.5),
    }
    if dims["qkv_bias"]:
        stack["bq"] = normal((n, hq), 0.02)
        stack["bk"] = normal((n, hkv), 0.02)
        stack["bv"] = normal((n, hkv), 0.02)
    if dims["experts"]:
        e, f = dims["experts"], dims["ffn"]
        mlp = {"router": normal((n, d, e), d ** -0.5, torch.float32),
               "w_gate": normal((n, e, d, f), d ** -0.5),
               "w_up": normal((n, e, d, f), d ** -0.5),
               "w_down": normal((n, e, f, d), f ** -0.5)}
    else:
        f = dims["ffn"]
        mlp = {"w_gate": normal((n, d, f), d ** -0.5),
               "w_up": normal((n, d, f), d ** -0.5),
               "w_down": normal((n, f, d), f ** -0.5)}
    ones = torch.ones((2 * n + 1, d), dtype=dtype, device=device)
    blocks = [{"ln1": {"scale": ones[2 * i]}, "ln2": {"scale": ones[2 * i + 1]},
               "attn": {k: v[i] for k, v in stack.items()},
               "mlp": {k: v[i] for k, v in mlp.items()}}
              for i in range(n)]
    return {"embed": normal((dims["vocab"], d), 0.02),
            "blocks": blocks,
            "ln_f": {"scale": ones[2 * n]},
            "head": normal((d, dims["vocab"]), d ** -0.5)}
