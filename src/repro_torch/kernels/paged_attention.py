"""Paged decode attention — the ADDRGEN/MMU analogue (paper C1 + C2).

One decode step: each sequence's query token attends to its KV cache in
physical pages of the shared pool.  The CUDA kernels
(``csrc/paged_attention.cu``) split each sequence's page range over blocks
``(KV head, sequence, split)``, each serving all ``G`` query heads of the
group.  A block reads each page-table entry itself before the page's burst
(one translation per burst), clamps -1 to frame 0, masks positions outside
``[max(len - window, 0), len)``; an empty sequence gives zeros.  int8
pools (``kv_scale``) are a compile-time variant that dequantizes each page
after its load.  :func:`decode_route` picks one of two kernels before the
launch:

* ``"mma"``: bf16 q with bf16 or int8 pools, D a multiple of 16 up to
  256, pages of a multiple of 8, G <= 16, 16-byte-aligned bases — the
  serve path's operands — on the tensor cores (``mma.sync`` with the G
  heads as rows, 16-key slices through per-warp ``cp.async`` rings, each
  split sized by its own sequence's pages, one launch: the splits of a
  (sequence, KV head) are one thread block cluster of at most
  :data:`MMA_SPLITS_MAX` blocks and merge through distributed shared
  memory, with no scratch); past D 128 (recurrentgemma-9b's 256) Q's
  fragments are staged in shared memory instead of registers;
* ``"simt"``: f32, other shapes and misaligned views, on the CUDA cores
  (splits of the table's width, f32 staging, a second merge launch).

Both routes take D up to :data:`D_MAX` = 256, G up to 16 and pages up to
64 tokens.

Replaces the TPU kernel ``paged_decode_attention`` of
``src/repro/kernels/paged_attention.py``.

Layouts: q ``[B, Hkv, G, D]``; pools ``[P, page, Hkv, D]`` in ``q.dtype``
or int8; page_table ``[>=B, max_pages]`` int32; seq_lens ``[>=B]`` int32.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 256
G_MAX = 16
PAGE_MAX = 64
ROUTES = ("mma", "simt")
#: the ``mma`` route's splits of one (sequence, KV head) form a cluster,
#: whose portable size is at most 8 blocks
MMA_SPLITS_MAX = 8


#: tokens a ``simt`` block stages in shared memory at once (whole pages)
#: at D <= 128; fewer past it (:func:`split_plan`)
TILE_TOKENS = 64


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(b: int, hkv: int, max_pages: int, page_size: int,
               sms: int, head_dim: int) -> tuple[int, int, int]:
    """``(pages_per_split, n_split, tile_pages)``: enough splits that the
    ``b * hkv * n_split`` blocks cover every SM about twice, no split
    shorter than one page, and tiles of whole pages up to 64 tokens at
    ``head_dim`` <= 128, ``64 * 128 / head_dim`` past it (the ``simt``
    block's f32 staging at D 256 and G 16: ~100 KB for 32 tokens, 168 KB
    for 64), and never less than one page.  The ``simt`` route cuts the
    table's width into ``n_split`` ranges of ``pages_per_split``; the
    ``mma`` route takes ``min(n_split, MMA_SPLITS_MAX)`` and cuts each
    sequence's own reached pages evenly.  A pure host function, so a
    captured launch keeps its grid."""
    n_split = max(1, min(max_pages, -(-2 * sms // max(b * hkv, 1))))
    pps = -(-max_pages // n_split)
    n_split = -(-max_pages // pps)
    tile_tokens = TILE_TOKENS * 128 // max(head_dim, 128)
    tile_pages = max(1, min(pps, tile_tokens // page_size))
    return pps, n_split, tile_pages


def decode_route(q, k_pool, v_pool, page_size: int) -> str:
    """Which kernel a call launches:

      * ``"mma"``: bf16 q with bf16 or int8 pools, D a multiple of 16 up
        to 256, ``page_size`` a multiple of 8, G <= 16, and 16-byte-aligned
        bases of q and both pools;
      * ``"simt"``: every other call (f32, D = 14, page 4, a misaligned
        view).

    A pure function of dtype, shape and alignment."""
    g, d = q.shape[2], q.shape[3]
    if (q.dtype != torch.bfloat16
            or k_pool.dtype not in (torch.bfloat16, torch.int8)
            or d % 16 or d > D_MAX or page_size % 8 or g > G_MAX):
        return "simt"
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        return "simt"
    return "mma"


def check_paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens,
                                 page_size: int, kv_scale, window) -> None:
    """Raise on anything the kernel does not take."""
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"q [B,Hkv,G,D] and pools [P,page,Hkv,D] expected, "
                         f"got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    b, hkv, g, d = q.shape
    if k_pool.shape[1] != page_size or k_pool.shape[2:] != (hkv, d):
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} at page_size={page_size}")
    if d > D_MAX or g > G_MAX or page_size > PAGE_MAX:
        raise ValueError(f"kernel takes D <= {D_MAX}, G <= {G_MAX}, "
                         f"page <= {PAGE_MAX}; got {d}, {g}, {page_size}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be one of {tuple(_DTYPES)}, got {q.dtype}")
    want = torch.int8 if kv_scale is not None else q.dtype
    if k_pool.dtype != want or v_pool.dtype != want:
        raise TypeError(f"pools must be {want} (kv_scale={kv_scale}), got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if page_table.dim() != 2 or page_table.shape[0] < b \
            or seq_lens.shape[0] < b:
        raise ValueError("page_table [>=B, max_pages], seq_lens [>=B] expected")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous() and seq_lens.is_contiguous()
            and page_table.stride(1) == 1):
        raise ValueError("q, pools and seq_lens must be contiguous")
    devs = {t.device for t in (q, k_pool, v_pool, page_table, seq_lens)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens, *,
                           page_size: int, scale: float | None = None,
                           window: int | None = None,
                           kv_scale: float | None = None):
    """Launch the CUDA kernel of :func:`decode_route` (the ``mma`` route in
    one launch, the ``simt`` route as a split pass and a merge); returns
    ``[B, Hkv, G, D]``.  CUDA tensors only."""
    check_paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens,
                                 page_size, kv_scale, window)
    if q.device.type != "cuda":
        raise ValueError("paged_decode_attention launches a CUDA kernel: "
                         "tensors must be on a CUDA device")
    b, hkv, g, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if b == 0:
        return out
    route = decode_route(q, k_pool, v_pool, page_size)
    max_pages = page_table.shape[1]
    pps, n_split, tile_pages = split_plan(
        b, hkv, max_pages, page_size, _sm_count(q.device.index or 0), d)
    if route == "mma":                  # a cluster per (b, h), no scratch
        n_split = min(n_split, MMA_SPLITS_MAX)
        part_acc = part_ml = out
    else:
        part_acc = torch.empty((b, hkv, n_split, g, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, hkv, n_split, g, 2), dtype=torch.float32,
                              device=q.device)
    fn = build.launcher("paged_attention")
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             part_acc.data_ptr(), part_ml.data_ptr(),
             b, hkv, g, d, page_size, max_pages, page_table.stride(0),
             window if window is not None else 0, float(scale),
             float(kv_scale if kv_scale is not None else 1.0),
             pps, n_split, tile_pages, _DTYPES[q.dtype],
             int(kv_scale is not None), int(route == "mma"),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    paged_decode_attention.routes[route] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.routes = dict.fromkeys(ROUTES, 0)
