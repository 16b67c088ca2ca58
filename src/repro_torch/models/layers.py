"""Dense-transformer layers in PyTorch: norms, RoPE, GQA projections, MLP.

Conventions (those of ``src/repro/models/layers.py``):
  * params are plain dicts of tensors; weights keep the JAX ``[in, out]``
    layout and are applied as ``x @ W``;
  * compute dtype follows the input; normalization statistics accumulate
    in f32; RoPE tables are built in f32;
  * initializers draw the same distributions as the JAX package from an
    explicit ``torch.Generator`` on the target device (the numbers differ
    from ``jax.random``; the tests bridge JAX weights instead).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def attention_init(gen: torch.Generator, cfg, dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    return p


def swiglu_init(gen: torch.Generator, d: int, f: int, dtype) -> Params:
    return {
        "w_gate": dense_init(gen, d, f, dtype),
        "w_up": dense_init(gen, d, f, dtype),
        "w_down": dense_init(gen, f, d, dtype),
    }


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2], f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) ``[..., S, 1, D/2]`` in f32 for ``positions [..., S]``:
    built once per forward call and shared by every layer."""
    inv = rope_freqs(head_dim, theta, positions.device)     # [D/2]
    ang = positions[..., None].float() * inv                # [..., S, D/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Split-half rotation (``src/repro/models/layers.py:72-83``) of
    ``x [..., S, H, D]`` by precomputed tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor,            # [..., S, H, D]
               positions: torch.Tensor,    # [..., S]
               theta: float) -> torch.Tensor:
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def qkv_project(params: Params, x: torch.Tensor, cfg):
    """x [B, S, D] -> q [B, S, H, hd], k/v [B, S, Hkv, hd]."""
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]
