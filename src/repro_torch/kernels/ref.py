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


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ y`` with f32 products and sums, cast to ``out_dtype`` (default
    x's dtype).  bf16 inputs widen to f32 exactly."""
    return (x.float() @ y.float()).to(out_dtype or x.dtype)


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


def paged_copy_at_ref(
    src: torch.Tensor,          # [B, S, W]
    pool: torch.Tensor,         # [P, page, W] — updated in place
    page_table: torch.Tensor,   # [B, max_pages] int32
    starts: torch.Tensor,       # [B] int32 — logical position of src[:, 0]
    lens: torch.Tensor,         # [B] int32
    *,
    page_size: int,
) -> torch.Tensor:
    """Continuation copy, in place: chunk token ``t < lens[b]`` lands at
    logical position ``starts[b] + t``.  Tokens whose page is unmapped
    (entry < 0) or past the table (``vpn >= max_pages``) are not stored,
    as in the JAX oracle; every other pool row keeps its bytes."""
    b, s, w = src.shape
    max_pages = page_table.shape[1]
    tok = torch.arange(s, device=src.device)
    pos = starts[:b, None].long() + tok[None, :]              # [B, S]
    vpn = pos // page_size
    entry = page_table[:b].gather(1, vpn.clamp(max=max_pages - 1))
    valid = ((tok[None, :] < lens[:b, None]) & (entry >= 0)
             & (vpn < max_pages))
    rows = entry.long() * page_size + pos % page_size
    pool.view(-1, w)[rows[valid]] = src[valid].to(pool.dtype)
    return pool


def paged_gather_ref(
    pool: torch.Tensor,            # [P, page, W]
    page_table_row: torch.Tensor,  # [max_pages] int32 — one sequence
    positions: torch.Tensor,       # [N] int32, any order, repeats allowed
    *,
    page_size: int,
) -> torch.Tensor:
    """Rows of ``pool`` at logical ``positions``, ``[N, W]``, one translation
    per element.  As the JAX oracle (whose jnp indexing clamps): a position
    past the table's reach reads the table's last entry and a ``-1`` entry
    reads frame 0.  Positions are non-negative; an entry ``>= P`` (a
    corrupt table) reads the last frame, so nothing outside the pool is
    read."""
    max_pages = page_table_row.shape[0]
    pos = positions.long()
    vpn = (pos // page_size).clamp(0, max_pages - 1)
    frames = page_table_row.long()[vpn].clamp(0, pool.shape[0] - 1)
    return pool[frames, pos % page_size]


def paged_prefill_attention_ref(
    q: torch.Tensor,            # [B, S, Hkv, G, D] chunk queries
    k_pool: torch.Tensor,       # [P, page, Hkv, D]
    v_pool: torch.Tensor,       # [P, page, Hkv, D]
    page_table: torch.Tensor,   # [B, max_pages] int32
    starts: torch.Tensor,       # [B] int32 — tokens already cached per row
    *,
    page_size: int,
    scale: float | None = None,
    kv_scale: float | None = None,
) -> torch.Tensor:
    """Gathers the whole logical prefix (``max_pages * page_size`` tokens)
    through the page table, then dense attention with a causal mask on
    absolute positions (``k_pos <= starts[b] + t``).  Entries -1 clamp to
    frame 0; ``kv_scale`` dequantizes int8 pools to ``q.dtype``.  Returns
    ``[B, S, Hkv, G, D]``."""
    b, s, hkv, g, d = q.shape
    max_pages = page_table.shape[1]
    max_t = max_pages * page_size
    scale = scale if scale is not None else d ** -0.5
    frames = page_table[:b].clamp(min=0).long()              # [B, maxp]
    k_log = k_pool[frames].reshape(b, max_t, hkv, d)
    v_log = v_pool[frames].reshape(b, max_t, hkv, d)
    if kv_scale is not None:
        k_log = (k_log.float() * kv_scale).to(q.dtype)
        v_log = (v_log.float() * kv_scale).to(q.dtype)
    positions = (starts[:b, None].long()
                 + torch.arange(s, device=q.device)[None, :])  # [B, S]
    k_pos = torch.arange(max_t, device=q.device)[None, None, :]
    causal = k_pos <= positions[:, :, None]                   # [B, S, maxT]
    sc = torch.einsum("bshgd,bthd->bshgt", q.float(), k_log.float()) * scale
    sc = torch.where(causal[:, :, None, None, :], sc, _NEG_INF)
    p = torch.softmax(sc, dim=-1)
    p = torch.where(causal[:, :, None, None, :], p, 0.0)
    o = torch.einsum("bshgt,bthd->bshgd", p, v_log.float())
    return o.to(q.dtype)


def wkv6_ref(
    r: torch.Tensor,            # [BH, T, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,            # decay in (0, 1)
    u: torch.Tensor,            # [BH, N] bonus
    initial_state: torch.Tensor | None = None,   # [BH, N, N] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 recurrence one step at a time: ``o_t = r_t^T (diag(u)
    k_t v_t^T + S)``, then ``S = diag(w_t) S + k_t v_t^T``.  Returns
    (o [BH, T, N] in r's dtype, final state [BH, N, N] f32)."""
    bh, t, n = r.shape
    s = (initial_state.float() if initial_state is not None
         else torch.zeros((bh, n, n), dtype=torch.float32, device=r.device))
    uf = u[:, :, None].float()
    outs = []
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]              # [BH, N, N]
        outs.append(torch.einsum("bi,bij->bj", r[:, i].float(), uf * kv + s))
        s = w[:, i, :, None].float() * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s


def wkv6_chunked_matmul_ref(
    r: torch.Tensor,            # [BH, T, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,            # decay in (0, 1)
    u: torch.Tensor,            # [BH, N]
    initial_state: torch.Tensor | None = None,
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel RWKV-6 (flash-linear-attention form), the plain
    version of the chunked kernel.  T is padded to a multiple of ``chunk``
    with identity steps (w = 1, k = 0).  Per chunk, with ``cum`` the
    inclusive and ``cum_excl`` the exclusive cumsum of ``log(max(w,
    1e-38))``:

      o_i = (r_i exp(cum_excl_i)) S
            + sum_{j<i} (sum_n r_in k_jn exp(cum_excl_in - cum_jn)) v_j
            + (r_i . u k_i) v_i
      S   = exp(cum_last) S + sum_j exp(cum_last - cum_j) k_j v_j^T

    Every exponent is <= 0; the mask is applied in log space (-inf)
    before the exp, so a masked entry never overflows."""
    bh, t, n = r.shape
    nc = -(-t // chunk)
    pad = nc * chunk - t
    out_dtype = r.dtype
    r, k, v, w = r.float(), k.float(), v.float(), w.float()
    if pad:
        zp = (0, 0, 0, pad)
        r = torch.nn.functional.pad(r, zp)
        k = torch.nn.functional.pad(k, zp)
        v = torch.nn.functional.pad(v, zp)
        w = torch.nn.functional.pad(w, zp, value=1.0)
    s = (initial_state.float() if initial_state is not None
         else torch.zeros((bh, n, n), dtype=torch.float32, device=r.device))
    uf = u.float()[:, None, :]
    idx = torch.arange(chunk, device=r.device)
    mask = (idx[:, None] > idx[None, :])[None, :, :, None]    # [1, C, C, 1]
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        rr, kk, vv, ww = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
        logw = torch.log(torch.clamp(ww, min=1e-38))
        cum = torch.cumsum(logw, dim=1)
        cum_excl = cum - logw
        o = torch.einsum("bcn,bnm->bcm", rr * torch.exp(cum_excl), s)
        delta = cum_excl[:, :, None, :] - cum[:, None, :, :]  # [BH, C, C, N]
        delta = torch.where(mask, delta, float("-inf"))
        att = torch.einsum("bin,bjn,bijn->bij", rr, kk, torch.exp(delta))
        o = o + torch.einsum("bij,bjm->bim", att, vv)
        o = o + (rr * uf * kk).sum(-1, keepdim=True) * vv
        tail = torch.exp(cum[:, -1:, :] - cum)                # [BH, C, N]
        s = torch.exp(cum[:, -1, :])[:, :, None] * s + torch.einsum(
            "bcn,bcm->bnm", kk * tail, vv)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :t].to(out_dtype), s
