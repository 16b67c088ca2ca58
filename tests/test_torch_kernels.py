"""Port kernel modules against the JAX package, on identical numpy inputs.

For each serve-path kernel of ``repro_torch`` the plain PyTorch version
(the path a CPU tensor takes through ``repro_torch.kernels.ops``) is held
against the JAX Pallas kernel in interpret mode on small cases and
against its ``repro.kernels.ref`` oracle on the rest:

  * paged_copy: a bit-identical pool, with a partial tail page and
    unmapped trailing bursts;
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

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_copy import paged_copy

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
    assert ops.launch_counts() == {"paged_copy": 0, "flash_attention": 0,
                                   "paged_decode_attention": 0,
                                   "paged_copy_at": 0,
                                   "paged_prefill_attention": 0,
                                   "wkv6": 0, "wkv6_chunked": 0}


def test_jax_side_runs_on_cpu():
    assert jax.devices()[0].platform == "cpu"
