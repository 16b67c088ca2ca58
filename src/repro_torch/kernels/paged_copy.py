"""Unit-stride paged copy — one translation per page-bounded burst (C2-burst).

Prefill writes freshly computed K/V tokens (logical order) into physical
pages of the shared pool.  The CUDA kernel (``csrc/paged_copy.cu``) runs
one block per ``(logical page, sequence)``: the block reads its own
page-table entry, then copies the burst's valid tokens into that frame.

Replaces the TPU kernel ``paged_copy`` of ``src/repro/kernels/paged_copy.py``
(its ``paged_copy_at`` half belongs to the continuation slice).  The pool
is updated in place; unmapped bursts and tokens past ``lens[b]`` are not
stored (the TPU kernel's trash frame and read-modify-write).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_ELEM = (torch.float32, torch.bfloat16, torch.int8)


def check_paged_copy(src, pool, page_table, lens, page_size: int) -> None:
    """Raise on anything the kernel does not take."""
    if src.dim() != 3 or pool.dim() != 3:
        raise ValueError(f"src [B,S,W] and pool [P,page,W] expected, got "
                         f"{tuple(src.shape)} and {tuple(pool.shape)}")
    b, s, w = src.shape
    if pool.shape[1] != page_size or pool.shape[2] != w:
        raise ValueError(f"pool {tuple(pool.shape)} does not hold "
                         f"page_size={page_size} rows of width {w}")
    if src.dtype != pool.dtype or pool.dtype not in _ELEM:
        raise TypeError(f"src {src.dtype} must equal the pool's dtype, one "
                        f"of {_ELEM}; got pool {pool.dtype}")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("page_table and lens must be int32")
    if page_table.dim() != 2 or page_table.shape[0] < b or lens.shape[0] < b:
        raise ValueError("page_table [>=B, max_pages] and lens [>=B] expected")
    if -(-s // page_size) > page_table.shape[1]:
        raise ValueError(f"{s} tokens exceed the page-table reach "
                         f"{page_table.shape[1]} x {page_size}")
    if src.stride(2) != 1 or pool.stride(2) != 1 or page_table.stride(1) != 1 \
            or not lens.is_contiguous():
        raise ValueError("rows must have unit stride and lens be contiguous")
    devs = {t.device for t in (src, pool, page_table, lens)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def paged_copy(src, pool, page_table, lens, *, page_size: int):
    """Launch the CUDA kernel: write ``src[b, :lens[b]]`` into ``pool`` in
    place through the page table.  CUDA tensors only."""
    check_paged_copy(src, pool, page_table, lens, page_size)
    if src.device.type != "cuda":
        raise ValueError("paged_copy launches a CUDA kernel: tensors must be "
                         "on a CUDA device")
    b, s, w = src.shape
    n_bursts = -(-s // page_size)
    if b == 0 or n_bursts == 0:
        return pool
    isz = src.element_size()
    fn = build.launcher("paged_copy")
    err = fn(src.data_ptr(), pool.data_ptr(), page_table.data_ptr(),
             lens.data_ptr(), b, s, n_bursts, page_size, w * isz,
             src.stride(0) * isz, src.stride(1) * isz,
             pool.stride(0) * isz, pool.stride(1) * isz, page_table.stride(0),
             torch.cuda.current_stream(src.device).cuda_stream)
    build.check(err, "paged_copy")
    paged_copy.launches += 1
    return pool


paged_copy.launches = 0
