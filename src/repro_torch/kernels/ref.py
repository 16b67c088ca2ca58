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


def ragged_dot_ref(xs: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ragged_dot``: row ``m`` of ``xs [M, K]`` times ``w[g]
    [K, N]`` of the group ``g`` that holds it (groups own consecutive rows,
    ``group_sizes [E]`` >= 0 of them each); rows past the last group are
    zero.  f32 products and sums, cast to xs's dtype.  One masked product a
    group, with no host read of the sizes (a CUDA graph captures it)."""
    m = xs.shape[0]
    ends = torch.cumsum(group_sizes.long(), 0)
    gid = torch.searchsorted(ends, torch.arange(m, device=xs.device),
                             right=True)                       # [M]
    x32 = xs.float()
    out = torch.zeros((m, w.shape[2]), dtype=torch.float32, device=xs.device)
    for g in range(w.shape[0]):
        out = torch.where((gid == g)[:, None], x32 @ w[g].float(), out)
    return out.to(xs.dtype)


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


def chunked_attention_ref(
    q: torch.Tensor,      # [B, Hq, Sq, D]
    k: torch.Tensor,      # [B, Hkv, Sk, D]
    v: torch.Tensor,      # [B, Hkv, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    bk: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``bk`` keys (the JAX
    package's ``chunked_attention_ref``, ``src/repro/kernels/ref.py:51``):
    a running max, normaliser and accumulator in f32 carried block to
    block, masked scores at -1e30.  Queries sit at the end of the keys
    (``q_pos = arange(Sq) + Sk - Sq``); ``window`` keeps keys in
    ``(q_pos - window, q_pos]``.  Plain in both packages (RG-LRU's
    windowed prefill attention); one ``[B, Hq, Sq, bk]`` score block is
    live at a time."""
    return _chunked_forward(q, k, v, causal, window, scale, bk)[0]


def _key_blocks(k: torch.Tensor, v: torch.Tensor, bk: int):
    """``(k0, k block, v block)`` in f32 over the keys, the last block
    padded with zero keys to ``bk``."""
    for k0 in range(0, k.shape[2], bk):
        kblk = k[:, :, k0:k0 + bk].float()
        vblk = v[:, :, k0:k0 + bk].float()
        pad = bk - kblk.shape[2]                 # the last block's zero keys
        if pad:
            kblk = torch.nn.functional.pad(kblk, (0, 0, 0, pad))
            vblk = torch.nn.functional.pad(vblk, (0, 0, 0, pad))
        yield k0, kblk, vblk


def _block_valid(k0: int, bk: int, sk: int, q_pos: torch.Tensor,
                 causal: bool, window: int | None) -> torch.Tensor:
    """``[Sq, bk]``: which keys of the block at ``k0`` each query sees."""
    k_pos = k0 + torch.arange(bk, device=q_pos.device)
    valid = (k_pos < sk)[None, :].expand(q_pos.shape[0], bk)
    if causal:
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
    return valid


def _chunked_forward(q, k, v, causal, window, scale, bk):
    """The blocked online softmax of :func:`chunked_attention_ref`;
    returns (out in q's dtype, the running max ``m`` and the normaliser
    ``l`` ``[B, Hkv, G, Sq]`` f32, ``l`` 0 replaced by 1)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d).float()
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    m = torch.full((b, hkv, g, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for k0, kblk, vblk in _key_blocks(k, v, bk):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kblk) * scale
        s = torch.where(_block_valid(k0, bk, sk, q_pos, causal, window), s,
                        _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vblk)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).reshape(b, hq, sq, d).to(q.dtype), m, l


class _ChunkedAttentionFlashBwd(torch.autograd.Function):
    """Chunked attention with the flash backward (JAX
    ``_chunked_attention_vjp``, ``src/repro/kernels/ref.py:445-569``).

    Autograd through the key-block loop would save every block's scores:
    O(Sq x Sk) again.  The forward saves only ``(q, k, v, out, m, l)``,
    O(Sq) beyond the inputs, and the backward recomputes each block's
    probabilities:

        p   = exp(s - m) / l
        dv += p^T do
        ds  = p (do v^T - rowsum(do * out)) scale
        dq += ds k ;  dk += ds^T q
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, bk):
        out, m, l = _chunked_forward(q, k, v, causal, window, scale, bk)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.opts = (causal, window, scale, bk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, window, scale, bk = ctx.opts
        b, hq, sq, d = q.shape
        _, hkv, sk, _ = k.shape
        g = hq // hkv
        sc = scale if scale is not None else d ** -0.5
        qg = q.reshape(b, hkv, g, sq, d).float()
        dog = do.reshape(b, hkv, g, sq, d).float()
        delta = (dog * out.reshape(b, hkv, g, sq, d).float()).sum(-1)
        q_pos = torch.arange(sq, device=q.device) + (sk - sq)
        dq = torch.zeros_like(qg)
        dks, dvs = [], []
        for k0, kblk, vblk in _key_blocks(k, v, bk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kblk) * sc
            s = torch.where(_block_valid(k0, bk, sk, q_pos, causal, window),
                            s, _NEG_INF)
            p = torch.exp(s - m[..., None]) / l[..., None]
            dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dog))
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vblk)
            ds = p * (dp - delta[..., None]) * sc
            dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kblk)
            dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qg))
        dk = torch.cat(dks, dim=2)[:, :, :sk]
        dv = torch.cat(dvs, dim=2)[:, :, :sk]
        return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None)


def chunked_attention_flashbwd_ref(
    q: torch.Tensor,      # [B, Hq, Sq, D]
    k: torch.Tensor,      # [B, Hkv, Sk, D]
    v: torch.Tensor,      # [B, Hkv, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    bk: int = 512,
) -> torch.Tensor:
    """:func:`chunked_attention_ref` with the flash backward (the same
    forward, O(Sq) residuals for the backward; JAX
    ``chunked_attention_flashbwd_ref``, ``src/repro/kernels/ref.py:572``).
    Plain in both packages; training's attention above 1,024 tokens or
    with a window."""
    return _ChunkedAttentionFlashBwd.apply(q, k, v, causal, window, scale,
                                           bk)


#: RG-LRU's decay constant: ``a = exp(-RGLRU_C softplus(lam) r)``
RGLRU_C = 8.0


def rglru_gate_products(conv: torch.Tensor, w_r: torch.Tensor,
                        w_i: torch.Tensor):
    """The RG-LRU's gate pre-activations ``(x @ w_r, x @ w_i)`` in f32,
    ``x = conv`` as f32, the weights upcast per call (JAX's order)."""
    conv32 = conv.float()
    return conv32 @ w_r.float(), conv32 @ w_i.float()


def rglru_ref(conv: torch.Tensor, w_r: torch.Tensor, w_i: torch.Tensor,
              lam: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The RG-LRU of one recurrent layer (JAX
    ``src/repro/models/rglru.py:183-189``): ``r = sigmoid(x @ w_r)``, ``i =
    sigmoid(x @ w_i)``, ``a = exp(-8 softplus(lam) r)``, ``bx = sqrt(max(1 -
    a^2, 1e-12)) (i x)`` and the recurrence of :func:`rglru_scan_ref`, all
    in f32 (``x = conv`` as f32).  conv ``[B, T, R]`` in the weights' dtype,
    w_r, w_i ``[R, R]``, lam ``[R]`` f32, h0 ``[B, R]`` f32; returns ``h
    [B, T, R]``."""
    return rglru_from_products(*rglru_gate_products(conv, w_r, w_i), conv,
                               lam, h0)


def rglru_from_products(pre_r: torch.Tensor, pre_i: torch.Tensor,
                        conv: torch.Tensor, lam: torch.Tensor,
                        h0: torch.Tensor) -> torch.Tensor:
    """:func:`rglru_ref` after the gate products: the gate math and the
    recurrence from the pre-activations ``pre_r``, ``pre_i [B, T, R]``
    (what the scan kernel computes)."""
    return rglru_scan_ref(*rglru_gates(pre_r, pre_i, conv, lam), h0)


def rglru_gates(pre_r: torch.Tensor, pre_i: torch.Tensor,
                conv: torch.Tensor, lam: torch.Tensor):
    """The gate math from the pre-activations: the decay ``a`` and the
    input ``bx [B, T, R]`` of the recurrence, f32."""
    r = torch.sigmoid(pre_r)
    i = torch.sigmoid(pre_i)
    a = torch.exp(-RGLRU_C * torch.nn.functional.softplus(lam) * r)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * conv.float())
    return a, bx


def rglru_scan_ref(a: torch.Tensor, bx: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """The RG-LRU recurrence one step at a time: ``h_t = a_t * h_{t-1} +
    bx_t`` from ``h_{-1} = h0``, one rounded product and one rounded sum a
    step (the kernel's arithmetic).  a, bx ``[B, T, R]``, h0 ``[B, R]``,
    all f32; returns ``h [B, T, R]``.  JAX folds ``h0`` into ``bx[:, 0]``
    and runs an associative scan, which sums in another order."""
    h = torch.empty_like(a)
    hv = h0
    for t in range(a.shape[1]):
        hv = a[:, t] * hv + bx[:, t]
        h[:, t] = hv
    return h


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


def _store_rows(pool: torch.Tensor, w: int, rows: torch.Tensor,
                valid: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``pool`` viewed as ``[rows, w]`` gets ``src[valid]`` at
    ``rows[valid]``, in place, and keeps every other row's bytes.  Static
    shapes (no boolean index, whose size needs the values): every entry
    writes, an invalid one the same row and value as the first valid
    entry (or row 0 its own value when none is valid), so duplicates
    carry equal values."""
    flat = pool.view(-1, w)
    rows, valid = rows.reshape(-1), valid.reshape(-1)
    if not rows.numel():
        return pool
    vals = src.reshape(-1, w).to(pool.dtype)
    first = valid.int().argmax().reshape(1)
    some = valid.any()
    row0 = torch.where(some, rows.index_select(0, first), 0)
    val0 = torch.where(some, vals.index_select(0, first), flat[:1])
    flat[torch.where(valid, rows, row0)] = torch.where(valid[:, None], vals,
                                                       val0)
    return pool


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
    return _store_rows(pool, w, rows, valid, src)


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
    return _store_rows(pool, w, rows, valid, src)


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
