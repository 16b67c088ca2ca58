"""Grouped (ragged) matrix product — the expert FFN of the MoE serve path.

``out[M, N] = xs[M, K] @ w[g(m)]`` for rows sorted by group: group ``e``
owns rows ``[off[e], off[e] + group_sizes[e])``, ``off`` the exclusive
prefix sum of ``group_sizes [E]`` (int32, on the device); rows past the
last group are zero.  The counterpart of ``jax.lax.ragged_dot``, which
``src/repro/models/moe.py:132-136`` runs three times a layer; XLA lowers
that itself, so this replaces no Pallas kernel.

The group sizes are computed on the device inside a CUDA graph (the
decode horizons, the K=1 step and the bucket programs are captured), so
the kernels read them from device memory and the grid is static in the
shapes: ``ceil(M / BM) + E`` row tiles times the column tiles, each block
finding its group and rows with one warp's scan of the sizes and exiting
before any load when past the last tile (``csrc/ragged_dot.cu``).  Three
kernels, picked by :func:`ragged_route` before the launch from the dtype
and the static shapes only:

* ``"mma"``: bf16 with fewer than :data:`WGMMA_ROWS` rows per expert on
  average (decode): a stream of the touched experts' weights, 32 x 64
  tiles so their strips spread over every SM, TMA boxes into a 4-stage
  mbarrier ring (32 KB of weights in flight a block, 4 blocks a SM),
  ``mma.sync`` m16n8k16 consumers;
* ``"wgmma"``: bf16 with more (prefill): 128 x 128 tiles of one group,
  TMA into a 6-stage ring, a producer warpgroup and two consumer
  warpgroups of ``wgmma`` with w read MN-major (``matmul.cu``'s design);
* ``"simt"``: f32 (true f32 FMAs: the reduced f32 configs hold parity with
  an f32 dot).

No route splits K, so two launches on the same operands agree bit for
bit.  bf16 operands the tensor-core kernels cannot address (K = 0, K or N
not a multiple of 8, bases or strides off 16 bytes) are refused: the
serve path never makes one.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_ELEM = (torch.float32, torch.bfloat16)
ROUTES = ("mma", "wgmma", "simt")
#: rows and columns of each route's output tile
TILES = {"mma": (32, 64), "wgmma": (128, 128), "simt": (64, 64)}
#: bf16 takes ``"wgmma"`` from this many rows per expert on average: on
#: the H100 the two routes cross between 24 and 32 (M 768 and 1,024 over
#: 32 experts at K 1024, N 512)
WGMMA_ROWS = 32
_CODES = {"simt": 0, "mma": 1, "wgmma": 2}


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
    bm, bn = TILES[ragged_route(xs, w)]
    m, e, n = xs.shape[0], w.shape[0], w.shape[2]
    if (m >= 1 << 26 or -(-n // 64) > 65535
            or (-(-m // bm) + e) * -(-n // bn) >= 1 << 31):
        raise ValueError(f"M = {m} or N = {n} too large")
    devs = {t.device for t in (xs, w, group_sizes)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def ragged_route(xs, w) -> str:
    """Which kernel a call on ``xs [M, K]``, ``w [E, K, N]`` launches:
    ``"simt"`` for f32; for bf16 ``"wgmma"`` when ``M >= WGMMA_ROWS * E``,
    else ``"mma"``.  A pure function of the dtype and the static shapes:
    the group sizes never enter."""
    if xs.dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if xs.shape[0] >= WGMMA_ROWS * w.shape[0] else "mma"


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
             w.stride(0), n, _CODES[route],
             torch.cuda.current_stream(xs.device).cuda_stream)
    build.check(err, "ragged_dot")
    ragged_dot.launches += 1
    ragged_dot.routes[route] += 1
    return out


ragged_dot.launches = 0
ragged_dot.routes = dict.fromkeys(ROUTES, 0)
