"""Per-element translated gather — the indexed-access path (C2-indexed).

AraOS pays "the latency of a dedicated address translation on each vector
element" for indexed memory operations, to keep exceptions precise — the
reason spmv and canneal underperform (§3.2).  The CUDA kernel
(``csrc/paged_gather.cu``) keeps that contract: every element of an
arbitrary-order gather reads its own position and its own page-table
entry.  :func:`gather_route` picks the kernel's route before the launch:

  * ``"bulk"``: a warp translates a batch of elements together and moves
    their rows with 1-D bulk copies through shared memory, the batch's
    adjacent output rows as one bulk store (16-byte aligned views, rows of
    :data:`BULK_ROWS` bytes: the serve pools' K rows);
  * ``"lanes"``: a group of lanes owns one element; its first lane
    translates and broadcasts the row's address, and the group copies the
    row (every other view: misaligned, narrow or very wide rows).

Replaces the TPU kernel ``paged_gather`` of
``src/repro/kernels/paged_gather.py``.  Sorting the positions first (one
translation per page) is ``ops.paged_gather_coalesced``, not this kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_ELEM = (torch.float32, torch.bfloat16, torch.int8)
ROUTES = ("bulk", "lanes")
#: row bytes the bulk route takes (``csrc/paged_gather.cu``'s
#: ``BULK_MIN_ROW`` / ``BULK_MAX_ROW``)
BULK_ROWS = (64, 16384)
_CODES = {"lanes": 0, "bulk": 1}


def check_paged_gather(pool, page_table_row, positions, page_size: int) -> None:
    """Raise on anything the kernel does not take."""
    if pool.dim() != 3 or pool.shape[1] != page_size:
        raise ValueError(f"pool [P, page_size={page_size}, W] expected, got "
                         f"{tuple(pool.shape)}")
    if pool.dtype not in _ELEM:
        raise TypeError(f"pool dtype must be one of {_ELEM}, got {pool.dtype}")
    if page_table_row.dim() != 1 or positions.dim() != 1:
        raise ValueError("page_table_row [max_pages] and positions [N] "
                         "expected")
    if page_table_row.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_table_row and positions must be int32")
    if page_table_row.shape[0] == 0 or pool.shape[0] == 0:
        raise ValueError("an empty page table or pool has no row to read")
    if pool.stride(2) != 1 or not page_table_row.is_contiguous() \
            or not positions.is_contiguous():
        raise ValueError("pool rows must have unit stride and the table row "
                         "and positions be contiguous")
    devs = {t.device for t in (pool, page_table_row, positions)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def alignment(*values: int) -> int:
    """The largest power of two up to 16 that divides every value (byte
    addresses, strides, row bytes)."""
    a = 16
    while a > 1 and any(v % a for v in values):
        a //= 2
    return a


def gather_route(row_bytes: int, align: int) -> str:
    """Which route a launch takes: ``"bulk"`` when every base, stride and
    the row are 16-byte aligned (``align`` from :func:`alignment`) and the
    row holds :data:`BULK_ROWS` bytes, else ``"lanes"``.  A pure function
    of the row's bytes and the view's alignment."""
    lo, hi = BULK_ROWS
    return "bulk" if align == 16 and lo <= row_bytes <= hi else "lanes"


def paged_gather(pool, page_table_row, positions, *, page_size: int):
    """Launch the CUDA kernel: ``pool`` rows at logical ``positions``,
    ``[N, W]`` in the pool's dtype.  CUDA tensors only."""
    check_paged_gather(pool, page_table_row, positions, page_size)
    if pool.device.type != "cuda":
        raise ValueError("paged_gather launches a CUDA kernel: tensors must "
                         "be on a CUDA device")
    n, w = positions.shape[0], pool.shape[2]
    out = torch.empty((n, w), dtype=pool.dtype, device=pool.device)
    if n == 0 or w == 0:
        return out
    isz = pool.element_size()
    row_bytes, sf, st = w * isz, pool.stride(0) * isz, pool.stride(1) * isz
    route = gather_route(row_bytes, alignment(pool.data_ptr(), out.data_ptr(),
                                              row_bytes, sf, st))
    fn = build.launcher("paged_gather")
    err = fn(pool.data_ptr(), page_table_row.data_ptr(), positions.data_ptr(),
             out.data_ptr(), n, page_size, page_table_row.shape[0],
             pool.shape[0], row_bytes, sf, st, row_bytes, _CODES[route],
             torch.cuda.current_stream(pool.device).cuda_stream)
    build.check(err, "paged_gather")
    paged_gather.launches += 1
    paged_gather.routes[route] += 1
    return out


paged_gather.launches = 0
paged_gather.routes = dict.fromkeys(ROUTES, 0)
