"""Unit-stride paged copy — one translation per page-bounded burst (C2-burst).

Prefill writes freshly computed K/V tokens (logical order) into physical
pages of the shared pool.  The CUDA kernel (``csrc/paged_copy.cu``) runs
one block per ``(logical page, sequence, tensor)``: the block reads its
row's lengths, then its page-table entry and the burst's tokens at once,
and copies the burst into that frame.  One launch writes one tensor, or a
layer's K and V (the pair forms, which share the table and the lengths).
Two counters, one per placement, each counting launches and launches per
route:

  * :func:`paged_copy` / :func:`paged_copy_kv` — chunk token ``t`` at
    logical position ``t`` (cold prefill);
  * :func:`paged_copy_at` / :func:`paged_copy_kv_at` — chunk token ``t``
    at logical position ``starts[b] + t``, not necessarily page-aligned
    (continuation prefill: forks, radix-cache hits, the re-prefilled tail
    of a partial restore).  One more burst than pages covers the page an
    unaligned window straddles.

:func:`copy_route` picks the kernel's route before the launch: ``"burst"``
moves each page burst as one contiguous byte range (the serve path's
views), ``"rows"`` copies row by row (strided or misaligned views).

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
ROUTES = ("burst", "rows")


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


def _check_pair(k_src, v_src, k_pool, v_pool) -> None:
    """The pair forms launch one kernel with one set of strides."""
    if (k_src.shape != v_src.shape or k_pool.shape != v_pool.shape
            or k_src.stride() != v_src.stride()
            or k_pool.stride() != v_pool.stride()):
        raise ValueError("K and V must share shapes and strides: src "
                         f"{tuple(k_src.shape)}/{tuple(v_src.shape)}, pool "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    # a meta tensor has no address: there, two pools are two tensors
    same = (k_pool is v_pool if k_pool.device.type == "meta"
            else k_pool.data_ptr() == v_pool.data_ptr())
    if same:
        raise ValueError("K and V must be written to two pools")


def check_paged_copy(src, pool, page_table, lens, page_size: int) -> None:
    """Raise on anything the kernel does not take."""
    _check_rows(src, pool, page_table, page_size, lens)
    if -(-src.shape[1] // page_size) > page_table.shape[1]:
        raise ValueError(f"{src.shape[1]} tokens exceed the page-table reach "
                         f"{page_table.shape[1]} x {page_size}")


def check_paged_copy_kv(k_src, v_src, k_pool, v_pool, page_table, lens,
                        page_size: int) -> None:
    for src, pool in ((k_src, k_pool), (v_src, v_pool)):
        check_paged_copy(src, pool, page_table, lens, page_size)
    _check_pair(k_src, v_src, k_pool, v_pool)


def check_paged_copy_at(src, pool, page_table, starts, lens,
                        page_size: int) -> None:
    """Raise on anything the continuation kernel does not take.  Unlike
    :func:`check_paged_copy` the chunk may reach past the table: tokens
    there are not stored."""
    _check_rows(src, pool, page_table, page_size, starts, lens)


def check_paged_copy_kv_at(k_src, v_src, k_pool, v_pool, page_table, starts,
                           lens, page_size: int) -> None:
    for src, pool in ((k_src, k_pool), (v_src, v_pool)):
        check_paged_copy_at(src, pool, page_table, starts, lens, page_size)
    _check_pair(k_src, v_src, k_pool, v_pool)


def copy_route(srcs, pools) -> str:
    """Which route a launch over the tensors ``srcs`` / ``pools`` (one or
    two of each, one layout) takes:

      * ``"burst"``: rows adjacent in src and in the frame (row stride ==
        W) and the bases, the row bytes and the batch and frame strides
        16-byte aligned — a page burst is then one contiguous byte range
        on both sides, moved in 16-byte units;
      * ``"rows"``: every other view (strided rows, a misaligned base or
        stride), copied row by row with the widest unit that divides every
        pointer and stride.

    A pure function of shape, strides and alignment."""
    src, pool = srcs[0], pools[0]
    w, isz = src.shape[2], src.element_size()
    if src.stride(1) != w or pool.stride(1) != w:
        return "rows"
    if any(t.data_ptr() % 16 for t in (*srcs, *pools)):
        return "rows"
    if (w * isz) % 16 or (src.stride(0) * isz) % 16 \
            or (pool.stride(0) * isz) % 16:
        return "rows"
    return "burst"


def _launch(counter, srcs, pools, page_table, starts, lens, page_size: int,
            n_bursts: int):
    """One launch over ``srcs`` -> ``pools``; ``counter`` is the wrapper
    whose ``launches`` and ``routes`` it adds to."""
    src, pool = srcs[0], pools[0]
    if src.device.type != "cuda":
        raise ValueError(f"{counter.__name__} launches a CUDA kernel: tensors "
                         "must be on a CUDA device")
    b, s, w = src.shape
    if b == 0 or n_bursts == 0:
        return
    isz = src.element_size()
    if page_size * w * isz >= 2**30:
        raise ValueError(f"a page of {page_size} rows of {w * isz} bytes "
                         "exceeds the kernel's 32-bit unit index")
    route = copy_route(srcs, pools)
    fn = build.launcher("paged_copy")
    err = fn(src.data_ptr(), srcs[-1].data_ptr(), pool.data_ptr(),
             pools[-1].data_ptr(), page_table.data_ptr(),
             starts.data_ptr() if starts is not None else None,
             lens.data_ptr(), b, s, n_bursts, len(srcs), page_size,
             page_table.shape[1], w * isz, src.stride(0) * isz,
             src.stride(1) * isz, pool.stride(0) * isz, pool.stride(1) * isz,
             page_table.stride(0), int(route == "burst"),
             torch.cuda.current_stream(src.device).cuda_stream)
    build.check(err, counter.__name__)
    counter.launches += 1
    counter.routes[route] += 1


def paged_copy(src, pool, page_table, lens, *, page_size: int):
    """Launch the CUDA kernel: write ``src[b, :lens[b]]`` into ``pool`` in
    place through the page table.  CUDA tensors only."""
    check_paged_copy(src, pool, page_table, lens, page_size)
    _launch(paged_copy, (src,), (pool,), page_table, None, lens, page_size,
            -(-src.shape[1] // page_size))
    return pool


def paged_copy_kv(k_src, v_src, k_pool, v_pool, page_table, lens, *,
                  page_size: int):
    """:func:`paged_copy` of K and V in one launch (counted once under
    ``paged_copy``); returns ``(k_pool, v_pool)``.  CUDA tensors only."""
    check_paged_copy_kv(k_src, v_src, k_pool, v_pool, page_table, lens,
                        page_size)
    _launch(paged_copy, (k_src, v_src), (k_pool, v_pool), page_table, None,
            lens, page_size, -(-k_src.shape[1] // page_size))
    return k_pool, v_pool


def paged_copy_at(src, pool, page_table, starts, lens, *, page_size: int):
    """Launch the CUDA kernel: write ``src[b, :lens[b]]`` at logical
    positions ``starts[b]...`` of ``pool``, in place, through the page
    table.  CUDA tensors only."""
    check_paged_copy_at(src, pool, page_table, starts, lens, page_size)
    s = src.shape[1]
    _launch(paged_copy_at, (src,), (pool,), page_table, starts, lens,
            page_size, -(-s // page_size) + 1 if s else 0)
    return pool


def paged_copy_kv_at(k_src, v_src, k_pool, v_pool, page_table, starts, lens,
                     *, page_size: int):
    """:func:`paged_copy_at` of K and V in one launch (counted once under
    ``paged_copy_at``); returns ``(k_pool, v_pool)``.  CUDA tensors
    only."""
    check_paged_copy_kv_at(k_src, v_src, k_pool, v_pool, page_table, starts,
                           lens, page_size)
    s = k_src.shape[1]
    _launch(paged_copy_at, (k_src, v_src), (k_pool, v_pool), page_table,
            starts, lens, page_size, -(-s // page_size) + 1 if s else 0)
    return k_pool, v_pool


for _fn in (paged_copy, paged_copy_at):
    _fn.launches = 0
    _fn.routes = dict.fromkeys(ROUTES, 0)
