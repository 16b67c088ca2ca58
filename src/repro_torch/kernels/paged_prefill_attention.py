"""Chunked-prefill paged attention — streaming KV pages per query block.

Continuation prefill extends a sequence that already holds ``start`` tokens
in the paged KV cache by a chunk of new tokens.  The CUDA kernels
(``csrc/paged_prefill_attention.cu``) run one block per ``(query block,
KV head, row)``: a query block is ``bq`` whole chunk tokens times the
``G`` query heads of the group, and the block walks the KV pages it can
causally reach — ``0 .. min(last_reachable_page, max_pages - 1)`` — reading
each page-table entry right before the page's burst, with an online
softmax in f32.  Pages above the block's causal diagonal are neither
loaded nor computed; -1 entries clamp to frame 0.  int8 pools
(``kv_scale``) are a compile-time variant that dequantizes each page after
its load.  :func:`prefill_route` picks one of two kernels before the
launch:

* ``"wgmma"``: bf16 q with bf16 or int8 pools, D a multiple of 16 up to
  128, pages of a multiple of 8 up to 64, G <= 16, and q rows and pools
  that 16-byte loads and TMA can address — the serve path's operands — on
  the tensor cores (128 query rows a block, pages as TMA boxes through an
  mbarrier ring, ``S = Q K^T`` and ``O += P V`` on ``wgmma``);
* ``"simt"``: f32, other shapes and misaligned views, on the CUDA cores
  (64 query rows a block, f32 FMAs from shared memory).

Replaces the TPU kernel ``paged_prefill_attention`` of
``src/repro/kernels/paged_prefill_attention.py``.  The TPU kernel takes
``bq = 32`` query tokens per block; these take :func:`query_block` of
their route (``128 // G`` or ``64 // G``: 18 or 9 at qwen2-7b's G = 7),
and :func:`pages_touched` counts what a route fetches with its block size.

Layouts: q ``[B, S, Hkv, G, D]`` (any strides, unit stride along D);
pools ``[P, page, Hkv, D]`` in ``q.dtype`` or int8; page_table
``[>=B, max_pages]`` int32; starts ``[>=B]`` int32.  Output
``[B, S, Hkv, G, D]`` contiguous in ``q.dtype``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 128
PAGE_MAX = 64
G_MAX_WGMMA = 16
ROUTES = ("wgmma", "simt")
#: query rows (tokens x group heads) a block holds, by route
ROWS = {"wgmma": 128, "simt": 64}


def prefill_route_rule(q_dtype, pool_dtype, group: int, head_dim: int,
                       page_size: int) -> str:
    """The route by dtype and shape alone (for aligned operands):
    ``"wgmma"`` for bf16 q with bf16 or int8 pools, ``head_dim`` a
    multiple of 16 up to 128, ``page_size`` a multiple of 8 up to 64 and
    ``group <= 16``; ``"simt"`` otherwise.  The executor counts the bytes
    the card fetches with it."""
    if (q_dtype != torch.bfloat16 or pool_dtype not in (torch.bfloat16,
                                                         torch.int8)
            or head_dim % 16 or head_dim > D_MAX or page_size % 8
            or page_size > PAGE_MAX or group > G_MAX_WGMMA):
        return "simt"
    return "wgmma"


def prefill_route(q, k_pool, v_pool, page_size: int) -> str:
    """Which kernel a call launches: :func:`prefill_route_rule`, and
    ``"simt"`` where q's base or its batch, token, head or group stride
    is not a multiple of 16 bytes (q is read with 16-byte loads), or a
    pool's base is not 16-byte aligned (TMA).  A pure function of dtype,
    shape, strides and alignment."""
    b, s, hkv, g, d = q.shape
    rule = prefill_route_rule(q.dtype, k_pool.dtype, g, d, page_size)
    if rule == "wgmma":
        if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
            return "simt"
        if any(q.stride(i) % 8 for i in range(4)):
            return "simt"
    return rule


def query_block(group: int, route: str) -> int:
    """Query tokens per block of ``route``'s kernel for a GQA group of
    ``group`` heads."""
    return max(1, ROWS[route] // group)


def last_reachable_page(start, qb, *, page_size: int, bq: int):
    """Last KV page query block ``qb`` can causally reach (padded block
    end): the clamp the kernel's page loop uses."""
    return (start + (qb + 1) * bq - 1) // page_size


def pages_touched(start: int, chunk: int, max_pages: int, *,
                  page_size: int, bq: int) -> int:
    """Pages the kernel fetches for one (start, chunk) row and KV head:
    ``last_reachable_page(...) + 1`` per query block, capped at the table.
    The plain version gathers ``max_pages`` instead, whatever the chunk."""
    if not chunk:
        return 0
    bq = max(1, min(bq, chunk))
    total = 0
    for qb in range(-(-chunk // bq)):
        last = last_reachable_page(start, qb, page_size=page_size, bq=bq)
        total += min(last + 1, max_pages)
    return total


def check_paged_prefill_attention(q, k_pool, v_pool, page_table, starts,
                                  page_size: int, kv_scale) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 5 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"q [B,S,Hkv,G,D] and pools [P,page,Hkv,D] "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, s, hkv, g, d = q.shape
    if k_pool.shape[1] != page_size or k_pool.shape[2:] != (hkv, d):
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} at page_size={page_size}")
    if d > D_MAX or g > ROWS["simt"] or page_size > PAGE_MAX:
        raise ValueError(f"kernel takes D <= {D_MAX}, G <= {ROWS['simt']}, "
                         f"page <= {PAGE_MAX}; got {d}, {g}, {page_size}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be one of {tuple(_DTYPES)}, got {q.dtype}")
    want = torch.int8 if kv_scale is not None else q.dtype
    if k_pool.dtype != want or v_pool.dtype != want:
        raise TypeError(f"pools must be {want} (kv_scale={kv_scale}), got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if page_table.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("page_table and starts must be int32")
    if page_table.dim() != 2 or page_table.shape[0] < b \
            or starts.shape[0] < b:
        raise ValueError("page_table [>=B, max_pages], starts [>=B] expected")
    if not (q.stride(4) == 1 and k_pool.is_contiguous()
            and v_pool.is_contiguous() and starts.is_contiguous()
            and page_table.stride(1) == 1):
        raise ValueError("q needs unit stride along D; pools and starts "
                         "must be contiguous")
    devs = {t.device for t in (q, k_pool, v_pool, page_table, starts)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def paged_prefill_attention(q, k_pool, v_pool, page_table, starts, *,
                            page_size: int, scale: float | None = None,
                            kv_scale: float | None = None):
    """Launch the CUDA kernel of :func:`prefill_route`; returns
    ``[B, S, Hkv, G, D]``.  CUDA tensors only."""
    check_paged_prefill_attention(q, k_pool, v_pool, page_table, starts,
                                  page_size, kv_scale)
    if q.device.type != "cuda":
        raise ValueError("paged_prefill_attention launches a CUDA kernel: "
                         "tensors must be on a CUDA device")
    b, s, hkv, g, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, s, hkv, g, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    route = prefill_route(q, k_pool, v_pool, page_size)
    bq = max(1, min(query_block(g, route), s))
    strides = (ctypes.c_longlong * 4)(*(q.stride(i) for i in range(4)))
    fn = build.launcher("paged_prefill_attention")
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), starts.data_ptr(), out.data_ptr(),
             ctypes.cast(strides, ctypes.c_void_p), b, s, hkv, g, d,
             page_size, page_table.shape[1], bq, page_table.stride(0),
             float(scale), float(kv_scale if kv_scale is not None else 1.0),
             _DTYPES[q.dtype], int(kv_scale is not None), k_pool.shape[0],
             int(route == "wgmma"),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    paged_prefill_attention.routes[route] += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.routes = dict.fromkeys(ROUTES, 0)
