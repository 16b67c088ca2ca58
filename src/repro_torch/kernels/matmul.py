"""Blocked matrix product — the paper's central benchmark kernel (§3.1).

AraOS evaluates virtual-memory overhead on matrix multiplication, "a
vector kernel that heavily requires the cooperation of the scalar core".
``csrc/matmul.cu`` computes ``x @ y`` with an f32 accumulator for f32 or
bf16 operands and writes f32 or bf16, for any M, N, K with no padded
copies, through one of two kernels that :func:`matmul_route` picks before
the launch:

* ``"wgmma"``: bf16 operands that TMA can address, on the tensor cores
  (128 x 256 tiles, TMA into a 4-stage mbarrier ring, two consumer
  warpgroups on ``wgmma``, y read MN-major);
* ``"simt"``: f32 operands (true f32 FMAs: the f32 contract is parity with
  an f32 dot) and bf16 ones TMA cannot address, on the CUDA cores, with a
  tile chosen by problem size and double-buffered K slabs
  (:func:`simt_config`).

Replaces the TPU kernel ``matmul`` of ``src/repro/kernels/matmul.py``.
Its ``bm``/``bn``/``bk`` are VMEM tiling choices of the TPU and have no
counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_ELEM = (torch.float32, torch.bfloat16)
#: output rows per block of the largest CUDA-core tile; the grid's y extent
#: is at most 65535 blocks
_BM = 128
ROUTES = ("wgmma", "simt")
#: square output tiles of the CUDA-core kernel, largest first
SIMT_TILES = (128, 64, 32, 16)


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


def matmul_route(x, y, out_dtype=None) -> str:
    """Which kernel a call on ``x``, ``y`` launches (the output type does
    not change it):

      * ``"wgmma"``: bf16 operands, K > 0, and both operands addressable by
        TMA — a base pointer and a row stride that are multiples of 16
        bytes (8 bf16);
      * ``"simt"``: every other call (f32 operands; bf16 with a row stride
        that is not a multiple of 8, such as a contiguous operand whose N
        or K is not; a misaligned view; K = 0).

    A pure function of dtype, shape, strides and alignment."""
    del out_dtype
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        return "simt"
    if x.shape[1] == 0:
        return "simt"
    for t in (x, y):
        if t.stride(0) % 8 or t.stride(1) != 1 or t.data_ptr() % 16:
            return "simt"
    return "wgmma"


def simt_config(x, y, sms: int) -> tuple[int, bool]:
    """The CUDA-core kernel a ``"simt"`` call on ``x``, ``y`` launches on a
    card of ``sms`` SMs: ``(tile, vec)``.

      * ``tile``: the largest square output tile of :data:`SIMT_TILES`
        that still gives every SM a block, else the smallest;
      * ``vec``: the f32 slabs arrive in 16-byte copies — f32 operands
        whose base pointers and row strides are multiples of 16 bytes.

    A pure function of dtype, shape, strides and alignment."""
    (m, _), n = x.shape, y.shape[1]
    tile = next((t for t in SIMT_TILES[:-1]
                 if -(-m // t) * -(-n // t) >= sms), SIMT_TILES[-1])
    vec = x.dtype == torch.float32 and all(
        t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0 for t in (x, y))
    return tile, vec


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
    route = matmul_route(x, y, out_dtype)
    tile, vec = simt_config(
        x, y, torch.cuda.get_device_properties(x.device).multi_processor_count)
    fn = build.launcher("matmul")
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
             x.stride(0), y.stride(0), n, int(x.dtype == torch.bfloat16),
             int(out_dtype == torch.bfloat16), int(route == "wgmma"), tile,
             int(vec), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "matmul")
    matmul.launches += 1
    matmul.routes[route] += 1
    return out


matmul.launches = 0
matmul.routes = dict.fromkeys(ROUTES, 0)
