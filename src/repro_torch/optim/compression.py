"""Int8 gradient compression with error feedback (port of
``src/repro/optim/compression.py``).

Per-tensor symmetric int8 quantization; the quantization residual is
carried into the next step, so the accumulated update is unbiased.  The
arithmetic is JAX's op for op (``torch.round`` rounds half to even, as
``jnp.round`` does), so a tensor quantizes to the same bytes in both
packages.  :func:`compressed_psum_tree` is the int8 all-reduce over a
mesh axis, with JAX's arithmetic in JAX's order; as in JAX, no train step
calls it.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


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


def compressed_psum_tree(grads: Any, err: Any, mesh, axis: str = "data"
                         ) -> tuple[Any, Any]:
    """All-reduce ``grads`` over the mesh ``axis`` in int8 with error
    feedback; returns (the mean of every rank's dequantized contribution
    in each gradient's dtype, the new f32 residuals).

    Each rank quantizes its ``gradient + residual`` per tensor, the int8
    payloads are summed in int32, the f32 scales averaged, and the sum
    dequantized with the mean scale (JAX's ``shard_map`` body,
    ``src/repro/optim/compression.py:53-86``): ``qsum * (psum(scale) / n)
    / n``.  The residual is the rank's own quantization error."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n = float(dist.get_world_size(group))

    def one(g, e):
        target = g.float() + e
        q, scale = quantize_int8(target)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=group)
        ssum = scale.clone()
        dist.all_reduce(ssum, group=group)
        ssum = ssum / n
        mean = qsum.float() * ssum / n
        return mean.to(g.dtype), target - dequantize_int8(q, scale)

    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))
