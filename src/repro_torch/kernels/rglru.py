"""The RG-LRU of one recurrent layer: gates, decay and recurrence, f32.

``h = rglru(conv, w_r, w_i, lam, h0)`` computes JAX's
``src/repro/models/rglru.py:183-189`` with ``x = conv`` as f32::

    r = sigmoid(x @ w_r), i = sigmoid(x @ w_i)
    a = exp(-8 softplus(lam) r)
    bx = sqrt(max(1 - a^2, 1e-12)) (i x)
    h_t = a_t h_{t-1} + bx_t,  h_{-1} = h0

recurrentgemma-9b's 26 recurrent layers call it once a prefill and a
decode step.  Two CUDA kernels in ``csrc/rglru.cu``, picked before the
launch by :func:`rglru_route` and counted per route:

* ``"step"`` (T = 1, bf16 weights, B <= :data:`STEP_MAX_ROWS`, rows that
  fit its shared memory: decode and a one-token prefill): one launch for the layer's whole step.  It
  streams ``w_r`` and ``w_i`` once (each block owns 32 channels of both
  gates), sums the exact bf16 products in f32 on the CUDA cores, with K
  split over the block and reduced in a fixed order, and applies the
  gate math and the step in its epilogue.  Its sums run in another order
  than the plain version's f32 product, so it agrees with the plain
  version within f32 rounding, not bit for bit; two launches agree bit
  for bit.  A programmatic dependent launch: it loads weights before the
  work ahead of it has finished, so ``w_r``, ``w_i`` and ``lam`` must
  not be written by the launch just before it (they are parameters).
* ``"scan"`` (T > 1, or f32 weights): the two products by ``torch.matmul``
  in f32 (as the plain version computes them), then one kernel that reads
  them with ``conv`` and ``lam``, forms ``a`` and ``bx`` in registers
  with PyTorch's CUDA arithmetic and walks T, a thread a (sequence,
  channel).

Replaces no TPU kernel: JAX leaves the gate math to XLA and computes the
recurrence with ``jax.lax.associative_scan`` (``_rglru_scan``,
``src/repro/models/rglru.py:53-67``).  The plain version is
:func:`repro_torch.kernels.ref.rglru_ref`.

Layouts: ``conv [B, T, R]`` in the weights' dtype (bf16 or f32), ``w_r``,
``w_i`` ``[R, R]`` (JAX's ``[in, out]``), ``lam [R]`` f32, ``h0 [B, R]``
f32, all contiguous; returns ``h [B, T, R]`` f32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

ROUTES = ("step", "scan")
_ELEM = (torch.bfloat16, torch.float32)
#: the most rows the step route takes (its conv rows staged in shared
#: memory, padded to 1, 2, 4, 8 or 16)
STEP_MAX_ROWS = 16
#: dynamic shared memory a block may use on the H100 (227 KB)
SMEM_MAX = 232448
_STEP_CH, _STEP_LANES, _STEP_WARPS = 32, 32, 8


#: the step route against its plain version: each row of h within this
#: share of the row's largest |h|.  Both sum the same exact bf16 products
#: in f32 but in other orders (4,096 terms: a few 1e-6 of a gate's
#: pre-activation), which the decay exp(-8.3 r) and the step carry into h.
STEP_TOL = 1e-5


def rglru_route(b: int, t: int, r: int, dtype) -> str:
    """Which kernel a call on ``conv [b, t, r]`` with weights of ``dtype``
    launches: ``"step"`` for ``t == 1``, bf16, ``b <= 16`` and rows that
    fit the step's shared memory (:func:`step_smem`), else ``"scan"``.  A
    pure function of the shape and the dtype."""
    if (t == 1 and dtype == torch.bfloat16 and b <= STEP_MAX_ROWS
            and step_smem(b, r) <= SMEM_MAX):
        return "step"
    return "scan"


def step_smem(b: int, r: int) -> int:
    """Shared memory of the step route at ``b`` rows and width ``r``: the
    conv rows (padded to a power of two, each to a multiple of the block's
    32 k lanes) and the per-warp partial sums (``csrc/rglru.cu``)."""
    nb = next(n for n in (1, 2, 4, 8, 16) if b <= n)
    kpad = -(-r // _STEP_LANES) * _STEP_LANES
    return nb * kpad * 2 + _STEP_WARPS * nb * 2 * _STEP_CH * 4


def check_rglru(conv, w_r, w_i, lam, h0) -> None:
    """Raise on anything the kernels do not take."""
    if conv.dim() != 3:
        raise ValueError(f"conv [B, T, R] expected, got {tuple(conv.shape)}")
    b, t, r = conv.shape
    if (w_r.shape != (r, r) or w_i.shape != (r, r) or lam.shape != (r,)
            or h0.shape != (b, r)):
        raise ValueError(f"w_r, w_i [{r}, {r}], lam [{r}] and h0 [{b}, {r}] "
                         f"expected, got {tuple(w_r.shape)}, "
                         f"{tuple(w_i.shape)}, {tuple(lam.shape)} and "
                         f"{tuple(h0.shape)}")
    if (conv.dtype not in _ELEM or w_r.dtype != conv.dtype
            or w_i.dtype != conv.dtype):
        raise TypeError(f"conv, w_r and w_i must share one dtype of {_ELEM}, "
                        f"got {conv.dtype}, {w_r.dtype} and {w_i.dtype}")
    if lam.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError(f"lam and h0 must be float32, got {lam.dtype} and "
                        f"{h0.dtype}")
    if not all(x.is_contiguous() for x in (conv, w_r, w_i, lam, h0)):
        raise ValueError("conv, w_r, w_i, lam and h0 must be contiguous")
    if b > 65535 or conv.numel() >= 1 << 40:
        raise ValueError(f"B = {b} or the sizes are too large")
    devs = {x.device for x in (conv, w_r, w_i, lam, h0)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def launch_scan(pre_r, pre_i, conv, lam, h0, h) -> None:
    """The scan kernel alone, on given f32 pre-activations ``pre_r``,
    ``pre_i [B, T, R]``, into ``h`` (contiguous CUDA tensors, checked by
    the caller); :func:`rglru` launches it after the two products."""
    b, t, r = conv.shape
    err = build.launcher("rglru_scan")(
        pre_r.data_ptr(), pre_i.data_ptr(), conv.data_ptr(),
        int(conv.dtype == torch.bfloat16), lam.data_ptr(), h0.data_ptr(),
        h.data_ptr(), b, t, r, torch.cuda.current_stream(conv.device)
        .cuda_stream)
    build.check(err, "rglru (scan)")


def rglru(conv, w_r, w_i, lam, h0):
    """Launch the route's CUDA kernel: ``h [B, T, R]`` f32.  CUDA tensors
    only."""
    check_rglru(conv, w_r, w_i, lam, h0)
    if conv.device.type != "cuda":
        raise ValueError("rglru launches a CUDA kernel: tensors must be on a "
                         "CUDA device")
    b, t, r = conv.shape
    h = torch.empty((b, t, r), dtype=torch.float32, device=conv.device)
    if h.numel() == 0:
        return h
    route = rglru_route(b, t, r, conv.dtype)
    if route == "step":
        vec = r % 8 == 0 and all(x.data_ptr() % 16 == 0
                                 for x in (conv, w_r, w_i))
        err = build.launcher("rglru_step")(
            conv.data_ptr(), w_r.data_ptr(), w_i.data_ptr(), lam.data_ptr(),
            h0.data_ptr(), h.data_ptr(), b, r, int(vec),
            torch.cuda.current_stream(conv.device).cuda_stream)
        build.check(err, "rglru (step)")
    else:
        launch_scan(*ref.rglru_gate_products(conv, w_r, w_i), conv, lam, h0,
                    h)
    rglru.launches += 1
    rglru.routes[route] += 1
    return h


rglru.launches = 0
rglru.routes = dict.fromkeys(ROUTES, 0)
