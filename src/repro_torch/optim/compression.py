"""Int8 gradient compression with error feedback (port of
``src/repro/optim/compression.py``).

Per-tensor symmetric int8 quantization; the quantization residual is
carried into the next step, so the accumulated update is unbiased.  The
arithmetic is JAX's op for op (``torch.round`` rounds half to even, as
``jnp.round`` does), so a tensor quantizes to the same bytes in both
packages.  JAX's ``compressed_psum_tree``, the int8 all-reduce over a
mesh axis, belongs with the sharded executor, where a collective runs.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q, scale f32)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(x: torch.Tensor, err: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x + err`` to int8 and back; returns (x_hat in x's dtype,
    the new residual f32)."""
    target = x.float() + err
    x_hat = dequantize_int8(*quantize_int8(target))
    return x_hat.to(x.dtype), target - x_hat


def init_error_state(grads: Any) -> Any:
    """Zero f32 residuals like ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
