"""Plain PyTorch versions of the serve-path kernels.

Each function computes what its CUDA kernel computes, on the same layouts
as the JAX package's oracles (``src/repro/kernels/ref.py``), with plain
tensor operations.  They are the path a CPU tensor takes through
:mod:`repro_torch.kernels.ops`, and ``chip_smoke.py`` holds every kernel
against them on the card.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,      # [B, Hq, Sq, D]
    k: torch.Tensor,      # [B, Hkv, Sk, D]
    v: torch.Tensor,      # [B, Hkv, Sk, D]
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(q_pos + (sk - sq) >= k_pos, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,            # [B, Hkv, G, D]
    k_pool: torch.Tensor,       # [P, page, Hkv, D]
    v_pool: torch.Tensor,       # [P, page, Hkv, D]
    page_table: torch.Tensor,   # [B, max_pages] int32
    seq_lens: torch.Tensor,     # [B] int32
    *,
    page_size: int,
    scale: float | None = None,
    window: int | None = None,
    kv_scale: float | None = None,
) -> torch.Tensor:
    """Gathers logical KV through the page table, then dense attention.

    ``kv_scale`` dequantizes int8 pools to ``q.dtype`` before the math, the
    precision the kernel's upcast lands on."""
    b, hkv, g, d = q.shape
    max_pages = page_table.shape[1]
    scale = scale if scale is not None else d ** -0.5
    page_table = page_table[:b]
    seq_lens = seq_lens[:b]
    frames = page_table.clamp(min=0).long()                 # [B, maxp]
    max_t = max_pages * page_size
    k_log = k_pool[frames].reshape(b, max_t, hkv, d)
    v_log = v_pool[frames].reshape(b, max_t, hkv, d)
    if kv_scale is not None:
        k_log = (k_log.float() * kv_scale).to(q.dtype)
        v_log = (v_log.float() * kv_scale).to(q.dtype)
    s = torch.einsum("bhgd,bthd->bhgt", q.float(), k_log.float()) * scale
    pos = torch.arange(max_t, device=q.device)[None, :]
    valid = pos < seq_lens[:, None]                          # [B, maxT]
    if window is not None:
        valid &= pos >= (seq_lens[:, None] - window).clamp(min=0)
    s = torch.where(valid[:, None, None, :], s, _NEG_INF)
    # fully-masked rows (empty sequences) -> zeros, matching the kernel
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid[:, None, None, :], p, 0.0)
    o = torch.einsum("bhgt,bthd->bhgd", p, v_log.float())
    return o.to(q.dtype)


def paged_copy_ref(
    src: torch.Tensor,          # [B, S, W]
    pool: torch.Tensor,         # [P, page, W] — updated in place
    page_table: torch.Tensor,   # [B, max_pages] int32
    lens: torch.Tensor,         # [B] int32
    *,
    page_size: int,
) -> torch.Tensor:
    """Write ``src[b, :lens[b]]`` through the page table, in place.

    Like the kernel, a token whose page-table entry is unmapped (< 0) is
    not stored: the TPU kernel sends such bursts to a trash frame, while
    the JAX oracle clamps them to frame 0.  Valid tokens always have mapped
    pages on the serve path, so only mapped-page writes are compared with
    the JAX package."""
    b, s, w = src.shape
    max_pages = page_table.shape[1]
    tok = torch.arange(s, device=src.device)
    vpn = tok // page_size
    entry = page_table[:b][:, vpn.clamp(max=max_pages - 1)]  # [B, S]
    valid = ((tok[None, :] < lens[:b, None]) & (entry >= 0)
             & (vpn[None, :] < max_pages))
    rows = entry.long() * page_size + (tok % page_size)[None, :]
    pool.view(-1, w)[rows[valid]] = src[valid].to(pool.dtype)
    return pool
