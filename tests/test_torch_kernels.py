"""Port kernel modules against the JAX package, on identical numpy inputs.

For each serve-path kernel of ``repro_torch`` the plain PyTorch version
(the path a CPU tensor takes through ``repro_torch.kernels.ops``) is held
against the JAX Pallas kernel in interpret mode on small cases and
against its ``repro.kernels.ref`` oracle on the rest:

  * paged_copy: a bit-identical pool, with a partial tail page and
    unmapped trailing bursts; the pair dispatcher (K and V in one call)
    against two JAX calls; and ``burst_plan``, a plain mirror of the card
    kernel's blocks, replayed on flat bytes against the plain versions
    over a hypothesis sweep;
  * flash_attention: atol = rtol = 1e-5 in f32 (both sides accumulate in
    f32; only the summation order differs), S not a multiple of 128, G > 1;
  * paged_decode_attention: atol = rtol = 1e-5, with a window, an empty
    sequence, -1 table entries and int8 pools at kv_scale = 1/24.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``); here the wrappers' input checks and the
device dispatch are tested.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                       # pragma: no cover
    from _prop_fallback import given, settings, st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_copy import copy_route, paged_copy

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def paged_case(seed, *, b, hkv, g, d, page, n_frames, max_pages, lens,
               quant=False):
    """numpy operands: distinct frames per row, -1 past each row's pages."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    shape = (n_frames, page, hkv, d)
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(n_frames)
    table = np.full((b, max_pages), -1, np.int32)
    for i, n in enumerate(lens):
        k = -(-n // page)
        table[i, :k] = perm[i * max_pages: i * max_pages + k]
    return q, kp, vp, table, np.asarray(lens, np.int32)


def copy_case(seed, dtype):
    """src [3, 20, 28] into a [24, 4, 28] pool: a full row, a partial tail
    page (13 tokens) followed by an unmapped burst, an empty unmapped row.
    Every valid token has a mapped page (the serve path's invariant)."""
    rng = np.random.default_rng(seed)
    b, s, w, page, frames, maxp = 3, 20, 28, 4, 24, 6
    if dtype == np.int8:
        src = rng.integers(-127, 128, (b, s, w)).astype(np.int8)
        pool = rng.integers(-127, 128, (frames, page, w)).astype(np.int8)
    else:
        src = rng.standard_normal((b, s, w)).astype(dtype)
        pool = rng.standard_normal((frames, page, w)).astype(dtype)
    perm = rng.permutation(frames).astype(np.int32)
    table = np.full((b, maxp), -1, np.int32)
    table[0, :5] = perm[:5]
    table[1, :4] = perm[5:9]
    lens = np.asarray([20, 13, 0], np.int32)
    return src, pool, table, lens, page


class TestPagedCopy:
    @pytest.mark.parametrize("dtype", [np.float32, np.int8])
    def test_bit_identical_to_pallas_kernel(self, dtype):
        src, pool, table, lens, page = copy_case(0, dtype)
        want = np.asarray(jops.paged_copy(
            jnp.asarray(src), jnp.asarray(pool), jnp.asarray(table),
            jnp.asarray(lens), page_size=page))
        got = ops.paged_copy(t(src), t(pool), t(table), t(lens),
                             page_size=page)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("dtype", [np.float32, np.int8])
    def test_bit_identical_to_oracle_on_mapped_pages(self, dtype):
        src, pool, table, lens, page = copy_case(1, dtype)
        want = np.asarray(jref.paged_copy_ref(
            jnp.asarray(src), jnp.asarray(pool), jnp.asarray(table),
            jnp.asarray(lens), page_size=page))
        got = ref.paged_copy_ref(t(src), t(pool), t(table), t(lens),
                                 page_size=page)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_updates_the_pool_in_place(self):
        src, pool, table, lens, page = copy_case(2, np.float32)
        pool_t = t(pool)
        out = ops.paged_copy(t(src), pool_t, t(table), t(lens),
                             page_size=page)
        assert out is pool_t
        frame = table[0, 0]
        np.testing.assert_array_equal(pool_t[frame].numpy(), src[0, :page])

    def test_checks(self):
        src, pool, table, lens, page = copy_case(3, np.float32)
        with pytest.raises(TypeError):      # src dtype != pool dtype
            ops.paged_copy(t(src), t(pool).double(), t(table), t(lens),
                           page_size=page)
        with pytest.raises(TypeError):      # int64 table
            ops.paged_copy(t(src), t(pool), t(table).long(), t(lens),
                           page_size=page)
        with pytest.raises(ValueError):     # wrong page size
            ops.paged_copy(t(src), t(pool), t(table), t(lens), page_size=8)
        with pytest.raises(ValueError):     # the kernel takes CUDA only
            paged_copy(t(src), t(pool), t(table), t(lens), page_size=page)


class TestPagedCopyPair:
    @pytest.mark.parametrize("dtype", [np.float32, np.int8])
    def test_pair_bit_identical_to_two_pallas_calls(self, dtype):
        """``ops.paged_copy_kv`` (plain route) writes K and V as JAX's
        ``ops.paged_copy`` (Pallas, interpret) does in two calls."""
        k_src, k_pool, table, lens, page = copy_case(4, dtype)
        v_src, v_pool, _, _, _ = copy_case(5, dtype)
        want = [np.asarray(jops.paged_copy(
            jnp.asarray(src), jnp.asarray(pool), jnp.asarray(table),
            jnp.asarray(lens), page_size=page))
            for src, pool in ((k_src, k_pool), (v_src, v_pool))]
        kp, vp = t(k_pool), t(v_pool)
        out = ops.paged_copy_kv(t(k_src), t(v_src), kp, vp, t(table),
                                t(lens), page_size=page)
        assert out[0] is kp and out[1] is vp
        np.testing.assert_array_equal(kp.numpy(), want[0])
        np.testing.assert_array_equal(vp.numpy(), want[1])

    def test_pair_checks(self):
        src, pool, table, lens, page = copy_case(6, np.float32)
        args = (t(table), t(lens))
        with pytest.raises(ValueError):     # one pool for K and V
            p = t(pool)
            ops.paged_copy_kv(t(src), t(src), p, p, *args, page_size=page)
        with pytest.raises(ValueError):     # V's rows apart, K's adjacent
            wide = torch.cat([t(src), t(src)], -1)[..., :src.shape[2]]
            ops.paged_copy_kv(t(src), wide, t(pool), t(pool), *args,
                              page_size=page)
        with pytest.raises(TypeError):      # V of another dtype
            ops.paged_copy_kv(t(src), t(src).double(), t(pool),
                              t(pool).double(), *args, page_size=page)
        with pytest.raises(ValueError):     # the kernel takes CUDA only
            from repro_torch.kernels.paged_copy import paged_copy_kv
            paged_copy_kv(t(src), t(src), t(pool), t(pool), *args,
                          page_size=page)

    def test_cpu_pair_launches_no_kernel(self):
        ops.reset_launch_counts()
        src, pool, table, lens, page = copy_case(7, np.float32)
        ops.paged_copy_kv(t(src), t(src), t(pool), t(pool), t(table),
                          t(lens), page_size=page)
        assert ops.launch_counts()["paged_copy"] == 0
        assert ops.route_counts()["paged_copy"] == {"burst": 0, "rows": 0}


# ---------------------------------------------------------------------------
# the card kernel's burst plan, mirrored in plain torch
# ---------------------------------------------------------------------------


def burst_plan(srcs, pools, page_table, starts, lens, *, page_size):
    """What ``csrc/paged_copy.cu`` moves, block by block: for each block
    ``(tensor z, row b, burst)`` the ``(src byte offset, pool byte offset,
    bytes)`` ranges its stores write, from the kernel's own integer
    arithmetic (``start``, ``t0``, ``u_lo``/``u_hi``, the ``vpn`` and
    entry tests).  The burst route moves one contiguous range a block;
    the rows route one range a row.  Offsets are from each tensor's first
    element."""
    src, pool = srcs[0], pools[0]
    b, s, w = src.shape
    isz = src.element_size()
    row_bytes = w * isz
    src_sb, src_ss = src.stride(0) * isz, src.stride(1) * isz
    pool_sf, pool_st = pool.stride(0) * isz, pool.stride(1) * isz
    max_pages = page_table.shape[1]
    route = copy_route(srcs, pools)
    n_bursts = -(-s // page_size) + (starts is not None)
    plan = {}
    for z in range(len(srcs)):
        for bi in range(b):
            start = int(starts[bi]) if starts is not None else 0
            n_tok = min(int(lens[bi]), s)
            for burst in range(n_bursts):
                vpn = start // page_size + burst
                t0 = burst * page_size - start % page_size
                u_lo, u_hi = max(0, -t0), min(page_size, n_tok - t0)
                moves = []
                if vpn < max_pages and u_hi > u_lo \
                        and int(page_table[bi, vpn]) >= 0:
                    so = bi * src_sb + (t0 + u_lo) * src_ss
                    po = int(page_table[bi, vpn]) * pool_sf + u_lo * pool_st
                    if route == "burst":
                        moves = [(so, po, (u_hi - u_lo) * row_bytes)]
                    else:
                        moves = [(so + r * src_ss, po + r * pool_st,
                                  row_bytes) for r in range(u_hi - u_lo)]
                plan[z, bi, burst] = moves
    return route, plan


def byte_view(x):
    """Every byte of ``x``'s storage from its first element on."""
    raw = torch.empty(0, dtype=torch.uint8).set_(x.untyped_storage())
    return raw[x.storage_offset() * x.element_size():]


def replay(plan, srcs, pools):
    for (z, _, _), moves in plan.items():
        sb, pb = byte_view(srcs[z]), byte_view(pools[z])
        for so, po, n in moves:
            pb[po: po + n] = sb[so: so + n]


def plan_case(seed, dtype, b, s, page, maxp, *, at, strided=False):
    """Random K/V, random-filled pools with distinct frames, ~1 in 6
    entries unmapped; continuation starts aligned or not, up to the
    table's end (rows may run past it); lens 0..S."""
    rng = np.random.default_rng(seed)
    w = 16 if dtype == np.int8 else 4         # 16-byte rows
    frames = b * maxp + 2

    def fill(shape):
        if dtype == np.int8:
            return t(rng.integers(-127, 128, shape).astype(np.int8))
        return t(rng.standard_normal(shape).astype(dtype))
    srcs = [fill((b, s, w + 4 * strided))[..., :w] for _ in range(2)]
    pools = [fill((frames, page, w)) for _ in range(2)]
    table = rng.permutation(frames)[: b * maxp].reshape(b, maxp)
    table = np.where(rng.random((b, maxp)) < 1 / 6, -1, table)
    lens = rng.integers(0, s + 1, b)
    starts = rng.integers(0, maxp * page + 1, b) if at else None
    if at and b > 1:
        starts[0] = (starts[0] // page) * page      # one aligned start
    return (srcs, pools, t(table.astype(np.int32)),
            None if starts is None else t(starts.astype(np.int32)),
            t(lens.astype(np.int32)))


def assert_plan_reproduces_plain(seed, dtype, b, s, page, maxp, at,
                                 strided=False):
    srcs, pools, table, starts, lens = plan_case(
        seed, dtype, b, s, page, maxp, at=at, strided=strided)
    route, plan = burst_plan(srcs, pools, table, starts, lens,
                             page_size=page)
    assert route == ("rows" if strided else "burst")
    want = [p.clone() for p in pools]
    for src, pool in zip(srcs, want):
        if starts is None:
            ref.paged_copy_ref(src, pool, table, lens, page_size=page)
        else:
            ref.paged_copy_at_ref(src, pool, table, starts, lens,
                                  page_size=page)
    got = [p.clone() for p in pools]
    replay(plan, srcs, got)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       dtype=st.sampled_from([np.float32, np.int8]),
       b=st.integers(1, 4), page=st.sampled_from([1, 2, 4, 8, 16]),
       tail=st.integers(0, 20), extra=st.integers(0, 2),
       at=st.booleans())
def test_burst_plan_reproduces_plain_versions(seed, dtype, b, page, tail,
                                              extra, at):
    """S = 1..3 pages + 20 (aligned or not), the table just reaching S
    or a little past it, lens 0..S, unmapped entries, unaligned starts and
    rows past the table: the kernel's blocks, replayed on bytes, give the
    plain versions' pools bit for bit."""
    s = max(1, page * (seed % 3) + tail)
    maxp = -(-s // page) + extra
    assert_plan_reproduces_plain(seed, dtype, b, s, page, maxp, at)


@pytest.mark.parametrize("at", [False, True])
@pytest.mark.parametrize("page", [4, 16])
def test_burst_plan_rows_route_on_strided_rows(page, at):
    """Rows apart in src (a slice of a wider projection): the rows route,
    one range a row, still the plain versions' bytes."""
    for seed in range(5):
        assert_plan_reproduces_plain(seed, np.float32, 3, 2 * page + 3,
                                     page, 4, at, strided=True)


def test_burst_plan_serve_shape_is_one_range_a_page():
    """The cold serve shape (bf16, W 512, page 16): every block of a fully
    covered page moves one 16 KB range."""
    gen = torch.Generator().manual_seed(0)
    srcs = [torch.randn((4, 368, 512), generator=gen).bfloat16()
            for _ in range(2)]
    pools = [torch.zeros((72, 16, 512), dtype=torch.bfloat16)
             for _ in range(2)]
    lens = torch.tensor([368, 290, 250, 184], dtype=torch.int32)
    perm = torch.randperm(71, generator=gen).int()
    table = torch.full((4, 23), -1, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens.tolist()):
        table[i, : -(-n // 16)] = perm[used: used - (-n // 16)]
        used -= -n // 16
    route, plan = burst_plan(srcs, pools, table, None, lens, page_size=16)
    sizes = [n for moves in plan.values() for _, _, n in moves]
    assert route == "burst"
    assert sum(sizes) == 2 * 1092 * 1024
    assert max(sizes) == 16 * 1024
    assert all(len(m) <= 1 for m in plan.values())
    want = [p.clone() for p in pools]
    for src, pool in zip(srcs, want):
        ref.paged_copy_ref(src, pool, table, lens, page_size=16)
    replay(plan, srcs, pools)
    assert all(torch.equal(a, b) for a, b in zip(pools, want))


class TestFlashAttention:
    @pytest.mark.parametrize("s", [20, 131])
    @pytest.mark.parametrize("hq,hkv", [(4, 2), (2, 2)])
    def test_matches_jax_oracle(self, s, hq, hkv):
        rng = np.random.default_rng(s + hq)
        q = rng.standard_normal((2, hq, s, 14)).astype(np.float32)
        k = rng.standard_normal((2, hkv, s, 14)).astype(np.float32)
        v = rng.standard_normal((2, hkv, s, 14)).astype(np.float32)
        want = np.asarray(jref.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
        got = ops.flash_attention(t(q), t(k), t(v), causal=True)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_matches_pallas_kernel(self):
        rng = np.random.default_rng(7)
        q = rng.standard_normal((1, 4, 20, 14)).astype(np.float32)
        k = rng.standard_normal((1, 2, 20, 14)).astype(np.float32)
        v = rng.standard_normal((1, 2, 20, 14)).astype(np.float32)
        want = np.asarray(jops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
        got = ops.flash_attention(t(q), t(k), t(v), causal=True)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_strided_views_as_the_model_passes_them(self):
        """q/k/v arrive as [B, S, H, D] memory viewed as [B, H, S, D]."""
        rng = np.random.default_rng(8)
        q = t(rng.standard_normal((2, 12, 4, 14)).astype(np.float32))
        k = t(rng.standard_normal((2, 12, 2, 14)).astype(np.float32))
        v = t(rng.standard_normal((2, 12, 2, 14)).astype(np.float32))
        got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
        want = ref.flash_attention_ref(q.transpose(1, 2).contiguous(),
                                       k.transpose(1, 2).contiguous(),
                                       v.transpose(1, 2).contiguous())
        torch.testing.assert_close(got, want, atol=0, rtol=0)

    def test_checks(self):
        q = torch.zeros(1, 3, 8, 14)
        k = torch.zeros(1, 2, 8, 14)
        with pytest.raises(ValueError):     # Hq % Hkv != 0
            ops.flash_attention(q, k, k)
        with pytest.raises(ValueError):     # head_dim > 128
            ops.flash_attention(torch.zeros(1, 2, 8, 130),
                                torch.zeros(1, 2, 8, 130),
                                torch.zeros(1, 2, 8, 130))
        with pytest.raises(TypeError):      # f16 is not taken
            ops.flash_attention(k.half(), k.half(), k.half())
        with pytest.raises(ValueError):     # the kernel takes CUDA only
            flash_attention(k, k, k)


class TestPagedDecodeAttention:
    CASE = dict(b=4, hkv=2, g=2, d=14, page=4, n_frames=40, max_pages=8,
                lens=[13, 0, 32, 1])

    @pytest.mark.parametrize("window", [None, 5])
    @pytest.mark.parametrize("quant", [False, True])
    def test_matches_jax_oracle(self, window, quant):
        q, kp, vp, table, lens = paged_case(3, quant=quant, **self.CASE)
        kvs = 1 / 24 if quant else None
        want = np.asarray(jref.paged_decode_attention_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lens), page_size=4,
            window=window, kv_scale=kvs))
        got = ops.paged_decode_attention(
            t(q), t(kp), t(vp), t(table), t(lens), page_size=4,
            window=window, kv_scale=kvs)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert np.all(got.numpy()[1] == 0.0)      # len 0 gives zeros

    @pytest.mark.parametrize("quant", [False, True])
    def test_matches_pallas_kernel(self, quant):
        q, kp, vp, table, lens = paged_case(4, quant=quant, **self.CASE)
        kvs = 1 / 24 if quant else None
        want = np.asarray(jops.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lens), page_size=4,
            kv_scale=kvs))
        got = ops.paged_decode_attention(
            t(q), t(kp), t(vp), t(table), t(lens), page_size=4, kv_scale=kvs)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_checks(self):
        q, kp, vp, table, lens = paged_case(5, **self.CASE)
        with pytest.raises(TypeError):      # int8 pools need kv_scale
            ops.paged_decode_attention(t(q), t(kp).to(torch.int8),
                                       t(vp).to(torch.int8), t(table),
                                       t(lens), page_size=4)
        with pytest.raises(ValueError):     # pool page != page_size
            ops.paged_decode_attention(t(q), t(kp), t(vp), t(table), t(lens),
                                       page_size=8)
        with pytest.raises(ValueError):     # an empty window
            ops.paged_decode_attention(t(q), t(kp), t(vp), t(table), t(lens),
                                       page_size=4, window=0)
        with pytest.raises(ValueError):     # the kernel takes CUDA only
            paged_decode_attention(t(q), t(kp), t(vp), t(table), t(lens),
                                   page_size=4)


def test_cpu_dispatch_launches_no_kernel():
    """A CPU tensor takes the plain version; the launch counters (bumped
    only where a kernel launches) stay at zero."""
    ops.reset_launch_counts()
    q, kp, vp, table, lens = paged_case(6, **TestPagedDecodeAttention.CASE)
    ops.paged_decode_attention(t(q), t(kp), t(vp), t(table), t(lens),
                               page_size=4)
    x = torch.zeros(1, 2, 8, 14)
    ops.flash_attention(x, x, x)
    y, u = torch.full((2, 32, 16), 0.5), torch.full((2, 16), 0.5)
    for chunks in (False, True):
        ops.wkv6(y, y, y, y, u, matmul_chunks=chunks)
    ops.ragged_dot(torch.ones(4, 8), torch.ones(2, 8, 8),
                   torch.tensor([3, 1], dtype=torch.int32))
    for dtype, steps in ((torch.bfloat16, 1), (torch.float32, 3)):
        ops.rglru(torch.full((2, steps, 8), 0.5, dtype=dtype),
                  torch.ones(8, 8, dtype=dtype), torch.ones(8, 8, dtype=dtype),
                  torch.full((8,), 0.5), torch.zeros(2, 8))
    assert ops.launch_counts() == {"paged_copy": 0, "flash_attention": 0,
                                   "paged_decode_attention": 0,
                                   "paged_copy_at": 0,
                                   "paged_prefill_attention": 0,
                                   "wkv6": 0, "wkv6_chunked": 0,
                                   "paged_gather": 0, "matmul": 0,
                                   "ragged_dot": 0, "rglru": 0}


def test_jax_side_runs_on_cpu():
    assert jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("dtype,m,e,route", [
    (torch.bfloat16, 32, 32, "mma"),        # granite decode, 4 lanes
    (torch.bfloat16, 1023, 32, "mma"),      # the threshold (32 rows per
    (torch.bfloat16, 1024, 32, "wgmma"),    # expert) and one row either
    (torch.bfloat16, 1025, 32, "wgmma"),    # side of it
    (torch.bfloat16, 16384, 32, "wgmma"),   # a 2,048-token prefill
    (torch.bfloat16, 127, 4, "mma"),
    (torch.bfloat16, 128, 4, "wgmma"),
    (torch.float32, 32, 32, "simt"),
    (torch.float32, 16384, 32, "simt"),
])
def test_ragged_route_is_a_function_of_static_shapes(dtype, m, e, route):
    """``ragged_route`` reads the dtype and the static shapes only: the
    same route for every grouping of the rows (a CUDA graph replays one
    launch over new sizes) and for shape-only (meta) tensors; the CPU call
    takes the plain version whatever the route."""
    import inspect

    from repro_torch.kernels.ragged_dot import ragged_route
    assert list(inspect.signature(ragged_route).parameters) == ["xs", "w"]
    k, n = 64, 16
    rng = np.random.default_rng(m + e)
    xs = t(rng.standard_normal((m, k), dtype=np.float32)).to(dtype)
    w = t(rng.standard_normal((e, k, n), dtype=np.float32)).to(dtype)
    assert ragged_route(xs, w) == route
    assert ragged_route(xs.to("meta"), w.to("meta")) == route
    for sizes in ([m] + [0] * (e - 1), [0] * (e - 1) + [m],
                  rng.multinomial(m, [1 / e] * e), [0] * e):
        gs = torch.tensor(np.asarray(sizes), dtype=torch.int32)
        ops.reset_launch_counts()
        out = ops.ragged_dot(xs, w, gs)
        assert out.shape == (m, n) and out.dtype == dtype
        assert ops.launch_counts()["ragged_dot"] == 0
        assert ragged_route(xs, w) == route


def _strided(shape, strides, dtype=torch.bfloat16):
    base = torch.zeros(sum((d - 1) * s for d, s in zip(shape, strides)) + 1,
                       dtype=dtype)
    return base.as_strided(shape, strides)


@pytest.mark.parametrize("case", [
    "k0", "k_odd", "n_odd", "xs_base", "xs_rows", "w_rows", "w_experts"])
def test_check_ragged_dot_refuses_unaddressable_bf16(case):
    """bf16 operands that neither tensor-core route can address (TMA needs
    16-byte-aligned bases and row strides, K and N multiples of 8, K > 0)
    are refused by ``check_ragged_dot`` on every device, before any
    launch; the same shapes in f32 take the plain version."""
    from repro_torch.kernels.ragged_dot import check_ragged_dot
    m, k, n, e = 40, 64, 16, 4
    xs, w = torch.zeros((m, k), dtype=torch.bfloat16), torch.zeros(
        (e, k, n), dtype=torch.bfloat16)
    if case == "k0":
        xs, w = xs[:, :0], w[:, :0]
    elif case == "k_odd":
        xs, w = xs[:, :20], w[:, :20]
    elif case == "n_odd":
        w = w[:, :, :12]
    elif case == "xs_base":
        xs = torch.zeros((m, k + 1), dtype=torch.bfloat16)[:, 1:]
    elif case == "xs_rows":
        xs = _strided((m, k), (k + 4, 1))
    elif case == "w_rows":
        w = _strided((e, k, n), (k * (n + 4), n + 4, 1))
    elif case == "w_experts":
        w = _strided((e, k, n), (k * n + 4, n, 1))
    gs = torch.tensor([10, 0, 20, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="tensor cores only"):
        check_ragged_dot(xs, w, gs)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="tensor cores only"):
        ops.ragged_dot(xs, w, gs)
    got = ops.ragged_dot(xs.float(), w.float(), gs)
    assert got.shape == (m, w.shape[2]) and not got.any()
    assert ops.launch_counts()["ragged_dot"] == 0
