"""The RG-LRU recurrence ``h_t = a_t * h_{t-1} + bx_t`` over time, f32.

recurrentgemma-9b's recurrent layers run it once per prefill (T = the
prompt) and per decode step (T = 1).  The CUDA kernel
(``csrc/rglru_scan.cu``) gives one thread to each (sequence, channel) and
walks T in order, with each step's loads coalesced over the channels and
the next 8 steps' ``a`` and ``bx`` loaded ahead; each step is one rounded
product and one rounded sum, so it agrees bit for bit with the plain
version (:func:`repro_torch.kernels.ref.rglru_scan_ref`).  One route,
``"simt"`` (the CUDA cores), counted per route as the other kernels are.

Replaces no TPU kernel: the counterpart of ``jax.lax.associative_scan``
in ``_rglru_scan`` (``src/repro/models/rglru.py:53-67``), which XLA lowers
itself; the plain version's step loop would launch two kernels a step.

Layouts: ``a``, ``bx`` ``[B, T, R]`` f32 contiguous, ``h0 [B, R]`` f32
contiguous; returns ``h [B, T, R]`` f32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

ROUTES = ("simt",)


def check_rglru_scan(a, bx, h0) -> None:
    """Raise on anything the kernel does not take."""
    if a.dim() != 3 or a.shape != bx.shape or h0.shape != (a.shape[0],
                                                          a.shape[2]):
        raise ValueError(f"a, bx [B, T, R] and h0 [B, R] expected, got "
                         f"{tuple(a.shape)}, {tuple(bx.shape)} and "
                         f"{tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (a, bx, h0)):
        raise TypeError(f"a, bx and h0 must be float32, got {a.dtype}, "
                        f"{bx.dtype} and {h0.dtype}")
    if not (a.is_contiguous() and bx.is_contiguous() and h0.is_contiguous()):
        raise ValueError("a, bx and h0 must be contiguous")
    if a.shape[0] > 65535 or a.numel() >= 1 << 40:
        raise ValueError(f"B = {a.shape[0]} or the sizes are too large")
    devs = {t.device for t in (a, bx, h0)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def rglru_scan(a, bx, h0):
    """Launch the CUDA kernel: ``h [B, T, R]`` f32.  CUDA tensors only."""
    check_rglru_scan(a, bx, h0)
    if a.device.type != "cuda":
        raise ValueError("rglru_scan launches a CUDA kernel: tensors must be "
                         "on a CUDA device")
    b, t, r = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    fn = build.launcher("rglru_scan")
    err = fn(a.data_ptr(), bx.data_ptr(), h0.data_ptr(), h.data_ptr(), b, t,
             r, torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    rglru_scan.routes["simt"] += 1
    return h


rglru_scan.launches = 0
rglru_scan.routes = dict.fromkeys(ROUTES, 0)
