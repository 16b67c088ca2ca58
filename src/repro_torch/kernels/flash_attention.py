"""Causal GQA flash attention for the prefill chunk.

``csrc/flash_attention.cu`` runs one block per ``(q-tile, query head,
batch row)`` and loops over KV tiles up to the causal diagonal with an
online softmax (running max, normaliser and accumulator in f32).  Query
head ``h`` reads KV head ``h // G``.  The ragged edge is masked in the
kernel: prefill lengths are multiples of ``page_size``, not of the tile.
:func:`flash_route` picks one of its two kernels before the launch:

* ``"wgmma"``: bf16 with D a multiple of 16 up to 128 and views TMA can
  address — the serve path's ``[B, S, H, D]`` memory seen as ``[B, H, S,
  D]`` qualifies — on the tensor cores (128 query rows a block, K/V tiles
  by TMA through an mbarrier ring, ``S = Q K^T`` and ``O += P V`` on
  ``wgmma``, the softmax in the accumulator registers);
* ``"simt"``: f32, other head dims and misaligned views, on the CUDA cores
  (f32 FMAs from shared memory).

Replaces the TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` and its wrapper's padding to 128
(``src/repro/kernels/ops.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 128
ROUTES = ("wgmma", "simt")


def check_flash_attention(q, k, v, causal: bool) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q [B,Hq,S,D], k/v [B,Hkv,S,D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"GQA needs matching B and D and Hq % Hkv == 0: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not 1 <= d <= D_MAX:
        raise ValueError(f"head_dim {d} outside [1, {D_MAX}]")
    if causal and sq > k.shape[2]:
        raise ValueError(f"causal attention needs Sq <= Sk, got {sq} > "
                         f"{k.shape[2]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {tuple(_DTYPES)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q/k/v must have unit stride along head_dim")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q/k/v must share one device")


def flash_route(q, k, v) -> str:
    """Which kernel a call on ``q [B, Hq, Sq, D]``, ``k``/``v [B, Hkv, Sk,
    D]`` launches:

      * ``"wgmma"``: bf16, D a multiple of 16 and at most 128, Sk > 0, and
        every view addressable by TMA — a 16-byte-aligned base and batch,
        head and token strides that are multiples of 8 elements;
      * ``"simt"``: every other call (f32, D = 14, a misaligned view).

    A pure function of dtype, shape, strides and alignment."""
    d = q.shape[3]
    if q.dtype != torch.bfloat16 or d % 16 or d > D_MAX or k.shape[2] == 0:
        return "simt"
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.stride(3) != 1 or t.data_ptr() % 16:
            return "simt"
        if any(t.stride(i) % 8 for i in range(3)):
            return "simt"
    return "wgmma"


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Launch the CUDA kernel; returns ``[B, Hq, Sq, D]``.  CUDA tensors
    only.  The output is a view of ``[B, Sq, Hq, D]`` memory, so the
    caller's ``transpose(1, 2).reshape(B, Sq, Hq * D)`` costs no copy."""
    check_flash_attention(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError("flash_attention launches a CUDA kernel: tensors "
                         "must be on a CUDA device")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b == 0 or sq == 0:
        return out
    route = flash_route(q, k, v)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)))
    fn = build.launcher("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, hq, hkv, sq, sk, d, float(scale), int(causal),
             _DTYPES[q.dtype], ctypes.cast(strides, ctypes.c_void_p),
             int(route == "wgmma"),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(ROUTES, 0)
