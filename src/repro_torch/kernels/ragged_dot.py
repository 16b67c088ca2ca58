"""Grouped (ragged) matrix product — the expert FFN of the MoE serve path.

``out[M, N] = xs[M, K] @ w[g(m)]`` for rows sorted by group: group ``e``
owns rows ``[off[e], off[e] + group_sizes[e])``, ``off`` the exclusive
prefix sum of ``group_sizes [E]`` (int32, on the device); rows past the
last group are zero.  The counterpart of ``jax.lax.ragged_dot``, which
``src/repro/models/moe.py:132-136`` runs three times a layer; XLA lowers
that itself, so this replaces no Pallas kernel.

The group sizes are computed on the device inside a CUDA graph (the
decode horizons, the K=1 step and the bucket programs are captured), so
the kernel reads them from device memory and its grid is static in M:
``ceil(M / 64) + E`` row tiles, each block finding its group and rows
from the sizes and exiting when past the last tile (``csrc/ragged_dot.cu``).
Two kernels, picked by :func:`ragged_route` before the launch:

* ``"mma"``: bf16 on the tensor cores (``mma.sync`` m16n8k16, 64 x 64
  tiles, a 4-stage ``cp.async`` ring of K slabs);
* ``"simt"``: f32 (true f32 FMAs: the reduced f32 configs hold parity with
  an f32 dot).

bf16 operands the tensor-core kernel cannot address (K = 0, K or N not a
multiple of 8, bases or strides off 16 bytes) are refused: the serve path
never makes one.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_ELEM = (torch.float32, torch.bfloat16)
ROUTES = ("mma", "simt")
#: rows and columns of both kernels' output tile
BM = BN = 64


def check_ragged_dot(xs, w, group_sizes) -> None:
    """Raise on anything the kernel does not take."""
    if xs.dim() != 2 or w.dim() != 3 or xs.shape[1] != w.shape[1]:
        raise ValueError(f"xs [M, K] and w [E, K, N] expected, got "
                         f"{tuple(xs.shape)} and {tuple(w.shape)}")
    if group_sizes.dim() != 1 or group_sizes.shape[0] != w.shape[0]:
        raise ValueError(f"group_sizes [E={w.shape[0]}] expected, got "
                         f"{tuple(group_sizes.shape)}")
    if w.shape[0] == 0:
        raise ValueError("w has no group")
    if xs.dtype != w.dtype or xs.dtype not in _ELEM:
        raise TypeError(f"xs and w must share one dtype of {_ELEM}, got "
                        f"{xs.dtype} and {w.dtype}")
    if group_sizes.dtype != torch.int32 or not group_sizes.is_contiguous():
        raise TypeError("group_sizes must be contiguous int32")
    if xs.stride(1) != 1 or w.stride(2) != 1:
        raise ValueError("xs and w rows must have unit stride")
    if xs.dtype == torch.bfloat16:
        k, n = w.shape[1], w.shape[2]
        if (k == 0 or k % 8 or n % 8 or xs.stride(0) % 8 or w.stride(0) % 8
                or w.stride(1) % 8 or xs.data_ptr() % 16
                or w.data_ptr() % 16):
            raise ValueError(
                "bf16 ragged_dot runs on the tensor cores only: K > 0, K and "
                "N multiples of 8, and 16-byte-aligned bases and strides "
                f"expected, got K {k}, N {n}, strides {xs.stride()} and "
                f"{w.stride()}")
    if xs.shape[0] >= 1 << 26 or -(-w.shape[2] // BN) > 65535:
        raise ValueError(f"M = {xs.shape[0]} or N = {w.shape[2]} too large")
    devs = {t.device for t in (xs, w, group_sizes)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def ragged_route(xs, w) -> str:
    """Which kernel a call on ``xs``, ``w`` launches: ``"mma"`` for bf16
    operands, ``"simt"`` for f32.  A pure function of the dtype."""
    return "mma" if xs.dtype == torch.bfloat16 else "simt"


def ragged_dot(xs, w, group_sizes):
    """Launch the CUDA kernel: ``[M, N]`` in xs's dtype.  CUDA tensors
    only; ``group_sizes`` must hold sizes >= 0."""
    check_ragged_dot(xs, w, group_sizes)
    if xs.device.type != "cuda":
        raise ValueError("ragged_dot launches a CUDA kernel: tensors must be "
                         "on a CUDA device")
    (m, k), (e, _, n) = xs.shape, w.shape
    out = torch.empty((m, n), dtype=xs.dtype, device=xs.device)
    if m == 0 or n == 0:
        return out
    route = ragged_route(xs, w)
    fn = build.launcher("ragged_dot")
    err = fn(xs.data_ptr(), w.data_ptr(), out.data_ptr(),
             group_sizes.data_ptr(), m, n, k, e, xs.stride(0), w.stride(1),
             w.stride(0), n, int(route == "mma"),
             torch.cuda.current_stream(xs.device).cuda_stream)
    build.check(err, "ragged_dot")
    ragged_dot.launches += 1
    ragged_dot.routes[route] += 1
    return out


ragged_dot.launches = 0
ragged_dot.routes = dict.fromkeys(ROUTES, 0)
