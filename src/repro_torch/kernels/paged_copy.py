"""Unit-stride paged copy — one translation per page-bounded burst (C2-burst).

Prefill writes freshly computed K/V tokens (logical order) into physical
pages of the shared pool.  The CUDA kernel (``csrc/paged_copy.cu``) runs
one block per ``(logical page, sequence)``: the block reads its own
page-table entry, then copies the burst's valid tokens into that frame.
Two entry points share it, each with its own launch counter:

  * :func:`paged_copy` — chunk token ``t`` at logical position ``t``
    (cold prefill);
  * :func:`paged_copy_at` — chunk token ``t`` at logical position
    ``starts[b] + t``, not necessarily page-aligned (continuation prefill:
    forks, radix-cache hits, the re-prefilled tail of a partial restore).
    One more burst than pages covers the page an unaligned window
    straddles.

Replaces the TPU kernels ``paged_copy`` and ``paged_copy_at`` of
``src/repro/kernels/paged_copy.py``.  The pool is updated in place;
unmapped pages, pages past the table and tokens past ``lens[b]`` are not
stored (the TPU kernels' trash frame and read-modify-write of the edge
pages): every pool row that holds no chunk token keeps its bytes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_ELEM = (torch.float32, torch.bfloat16, torch.int8)


def _check_rows(src, pool, page_table, page_size: int, *vectors) -> None:
    """The checks both entry points share; ``vectors`` are the per-row
    int32 operands (``lens``, and ``starts`` for the continuation copy)."""
    if src.dim() != 3 or pool.dim() != 3:
        raise ValueError(f"src [B,S,W] and pool [P,page,W] expected, got "
                         f"{tuple(src.shape)} and {tuple(pool.shape)}")
    b, _, w = src.shape
    if pool.shape[1] != page_size or pool.shape[2] != w:
        raise ValueError(f"pool {tuple(pool.shape)} does not hold "
                         f"page_size={page_size} rows of width {w}")
    if src.dtype != pool.dtype or pool.dtype not in _ELEM:
        raise TypeError(f"src {src.dtype} must equal the pool's dtype, one "
                        f"of {_ELEM}; got pool {pool.dtype}")
    if page_table.dtype != torch.int32 or any(
            v.dtype != torch.int32 for v in vectors):
        raise TypeError("page_table, lens and starts must be int32")
    if page_table.dim() != 2 or page_table.shape[0] < b or any(
            v.shape[0] < b for v in vectors):
        raise ValueError("page_table [>=B, max_pages], lens and starts "
                         "[>=B] expected")
    if src.stride(2) != 1 or pool.stride(2) != 1 or page_table.stride(1) != 1 \
            or not all(v.is_contiguous() for v in vectors):
        raise ValueError("rows must have unit stride and lens/starts be "
                         "contiguous")
    devs = {t.device for t in (src, pool, page_table, *vectors)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def check_paged_copy(src, pool, page_table, lens, page_size: int) -> None:
    """Raise on anything the kernel does not take."""
    _check_rows(src, pool, page_table, page_size, lens)
    if -(-src.shape[1] // page_size) > page_table.shape[1]:
        raise ValueError(f"{src.shape[1]} tokens exceed the page-table reach "
                         f"{page_table.shape[1]} x {page_size}")


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
             page_table.shape[1],
             torch.cuda.current_stream(src.device).cuda_stream)
    build.check(err, "paged_copy")
    paged_copy.launches += 1
    return pool


paged_copy.launches = 0


def check_paged_copy_at(src, pool, page_table, starts, lens,
                        page_size: int) -> None:
    """Raise on anything the continuation kernel does not take.  Unlike
    :func:`check_paged_copy` the chunk may reach past the table: tokens
    there are not stored."""
    _check_rows(src, pool, page_table, page_size, starts, lens)


def paged_copy_at(src, pool, page_table, starts, lens, *, page_size: int):
    """Launch the CUDA kernel: write ``src[b, :lens[b]]`` at logical
    positions ``starts[b]...`` of ``pool``, in place, through the page
    table.  CUDA tensors only."""
    check_paged_copy_at(src, pool, page_table, starts, lens, page_size)
    if src.device.type != "cuda":
        raise ValueError("paged_copy_at launches a CUDA kernel: tensors must "
                         "be on a CUDA device")
    b, s, w = src.shape
    if b == 0 or s == 0:
        return pool
    n_bursts = -(-s // page_size) + 1
    isz = src.element_size()
    fn = build.launcher("paged_copy_at")
    err = fn(src.data_ptr(), pool.data_ptr(), page_table.data_ptr(),
             starts.data_ptr(), lens.data_ptr(), b, s, n_bursts, page_size,
             w * isz, src.stride(0) * isz, src.stride(1) * isz,
             pool.stride(0) * isz, pool.stride(1) * isz, page_table.stride(0),
             page_table.shape[1],
             torch.cuda.current_stream(src.device).cuda_stream)
    build.check(err, "paged_copy_at")
    paged_copy_at.launches += 1
    return pool


paged_copy_at.launches = 0
