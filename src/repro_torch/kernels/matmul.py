"""Blocked matrix product — the paper's central benchmark kernel (§3.1).

AraOS evaluates virtual-memory overhead on matrix multiplication, "a
vector kernel that heavily requires the cooperation of the scalar core".
The CUDA kernel (``csrc/matmul.cu``) computes ``x @ y`` with f32 products
and an f32 accumulator for f32 or bf16 operands, and writes f32 or bf16:
a 128x128 output tile per block, an 8x8 register tile per thread, K staged
through shared memory, boundary tiles guarded in the kernel (any M, N, K,
no padded copies).

Replaces the TPU kernel ``matmul`` of ``src/repro/kernels/matmul.py``.
Its ``bm``/``bn``/``bk`` are VMEM tiling choices of the TPU and have no
counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_ELEM = (torch.float32, torch.bfloat16)
#: output rows per block; the grid's y extent is at most 65535 blocks
_BM = 128


def check_matmul(x, y, out_dtype=None) -> None:
    """Raise on anything the kernel does not take."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"x [M, K] and y [K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in _ELEM:
        raise TypeError(f"x and y must share one dtype of {_ELEM}, got "
                        f"{x.dtype} and {y.dtype}")
    if out_dtype is not None and out_dtype not in _ELEM:
        raise TypeError(f"out_dtype must be one of {_ELEM}, got {out_dtype}")
    if x.stride(1) != 1 or y.stride(1) != 1:
        raise ValueError("x and y rows must have unit stride")
    if -(-x.shape[0] // _BM) > 65535:
        raise ValueError(f"M = {x.shape[0]} exceeds {65535 * _BM} rows")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} and y on {y.device}")


def matmul(x, y, *, out_dtype=None):
    """Launch the CUDA kernel: ``x @ y`` accumulated in f32, as
    ``out_dtype`` (default x's dtype).  CUDA tensors only."""
    check_matmul(x, y, out_dtype)
    if x.device.type != "cuda":
        raise ValueError("matmul launches a CUDA kernel: tensors must be on "
                         "a CUDA device")
    (m, k), n = x.shape, y.shape[1]
    out_dtype = out_dtype or x.dtype
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = build.launcher("matmul")
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
             x.stride(0), y.stride(0), n, int(x.dtype == torch.bfloat16),
             int(out_dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
