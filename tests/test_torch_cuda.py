"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs a CUDA card and ``nvcc`` and skips with a
reason anywhere else (the CPU tests hold the plain versions against the
JAX package; these hold the kernels against the plain versions).  Run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 (both sides accumulate in f32 in different orders);
bf16 2e-2 (outputs round to bf16, one ulp is 2^-8 relative), and for the
continuation attention four bf16 steps of the largest output
(``4 * 2^-8 * max|want|``); the copies are bit-identical on the whole pool;
the WKV recurrences (f32) 1e-4 sequential and 3e-4 chunked, 1e-3 at a
decay of 1e-6, as their CPU tests against the Pallas kernels.
"""

import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_copy_bit_identical(gen, dtype):
    b, s, w, page, frames = 4, 37, 512, 16, 20
    src = torch.randn((b, s, w), generator=gen, device="cuda").mul(50).to(dtype)
    pool = torch.zeros((frames, page, w), dtype=dtype, device="cuda")
    perm = torch.randperm(frames, generator=gen, device="cuda").int()
    table = perm[: b * 3].view(b, 3).contiguous()
    table[3, 1:] = -1
    lens = torch.tensor([37, 16, 1, 9], dtype=torch.int32, device="cuda")
    got = ops.paged_copy(src, pool.clone(), table, lens, page_size=page)
    want = ref.paged_copy_ref(src, pool.clone(), table, lens, page_size=page)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,hq,hkv,d", [
    (torch.float32, 4, 2, 14), (torch.bfloat16, 28, 4, 128)])
@pytest.mark.parametrize("s", [16, 100, 257])
def test_flash_attention(gen, dtype, hq, hkv, d, s):
    q = torch.randn((2, s, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((2, s, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((2, s, hkv, d), generator=gen, device="cuda").to(dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    got = ops.flash_attention(qt, kt, vt)
    want = ref.flash_attention_ref(qt, kt, vt)
    torch.testing.assert_close(got, want, atol=tol(dtype), rtol=tol(dtype))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,hkv,g,d,page", [
    (torch.float32, 2, 2, 14, 4), (torch.bfloat16, 4, 7, 128, 16)])
def test_paged_decode_attention(gen, quant, dtype, hkv, g, d, page):
    b, frames, maxp = 4, 64, 12
    lens = [page * 5 + 3, 0, 1, page * maxp]
    q = torch.randn((b, hkv, g, d), generator=gen, device="cuda").to(dtype)
    shape = (frames, page, hkv, d)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
    else:
        kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(frames, generator=gen, device="cuda").int()
    table = torch.full((b, maxp), -1, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lens):
        table[i, : -(-n // page)] = perm[i * maxp: i * maxp + -(-n // page)]
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kvs = 1 / 24 if quant else None
    for window in (None, page + 2):
        got = ops.paged_decode_attention(q, kp, vp, table, sl, page_size=page,
                                         window=window, kv_scale=kvs)
        want = ref.paged_decode_attention_ref(q, kp, vp, table, sl,
                                              page_size=page, window=window,
                                              kv_scale=kvs)
        torch.testing.assert_close(got, want, atol=tol(dtype),
                                   rtol=tol(dtype))
        assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_copy_at_bit_identical(gen, dtype):
    """Unaligned start ending mid-page (both edge pages), aligned start, a
    1-token chunk, a padded row across an unmapped page, and a row that
    runs past the table; the strided layer view as the model passes it."""
    b, s, w, page, frames, maxp = 5, 37, 512, 16, 40, 6
    src = torch.randn((b, s, w), generator=gen, device="cuda").mul(50).to(dtype)
    pools = torch.randn((2, frames, page, w), generator=gen,
                        device="cuda").mul(50).to(dtype)
    perm = torch.randperm(frames, generator=gen, device="cuda").int()
    table = perm[: b * maxp].view(b, maxp).contiguous()
    table[3, 2] = -1
    starts = torch.tensor([5, 32, 77, 20, 70], dtype=torch.int32,
                          device="cuda")
    lens = torch.tensor([37, 16, 1, 30, 37], dtype=torch.int32, device="cuda")
    got = ops.paged_copy_at(src, pools[1].clone(), table, starts, lens,
                            page_size=page)
    want = ref.paged_copy_at_ref(src, pools[1].clone(), table, starts, lens,
                                 page_size=page)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,hkv,g,d,page", [
    (torch.float32, 2, 2, 14, 4), (torch.bfloat16, 4, 7, 128, 16)])
def test_paged_prefill_attention(gen, quant, dtype, hkv, g, d, page):
    """Rows at mid-page, page-aligned and zero starts with chunks of 37, 1
    and 16 tokens (a padded batch of S = 37), -1 entries past each row's
    pages, q as the strided view of the projection."""
    b, frames, maxp = 3, 64, 12
    starts = torch.tensor([page + 3, 2 * page, 0], dtype=torch.int32,
                          device="cuda")
    chunks = [37, 1, 16]
    s = max(chunks)
    q = torch.randn((b, s, hkv * g * d), generator=gen,
                    device="cuda").to(dtype).view(b, s, hkv, g, d)
    shape = (frames, page, hkv, d)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
    else:
        kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(frames, generator=gen, device="cuda").int()
    table = torch.full((b, maxp), -1, dtype=torch.int32, device="cuda")
    for i, c in enumerate(chunks):
        n = -(-(int(starts[i]) + c) // page)
        table[i, :n] = perm[i * maxp: i * maxp + n]
    kvs = 1 / 24 if quant else None
    got = ops.paged_prefill_attention(q, kp, vp, table, starts,
                                      page_size=page, kv_scale=kvs)
    want = ref.paged_prefill_attention_ref(q, kp, vp, table, starts,
                                           page_size=page, kv_scale=kvs)
    for i, c in enumerate(chunks):
        g_, w_ = got[i, :c].float(), want[i, :c].float()
        if dtype == torch.float32:
            torch.testing.assert_close(g_, w_, atol=1e-5, rtol=1e-5)
        else:
            err = float((g_ - w_).abs().max())
            assert err <= 4 * 2**-8 * float(w_.abs().max()), (i, err)


def wkv_operands(gen, bh, t, n, *, state, decay=None):
    """f32 r, k, v (scale 0.5), w = sigmoid(z - 1) or a constant decay,
    u, and an optional state (scale 0.1), contiguous on the card."""
    def f(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * sc
    r, k, v = f(bh, t, n, sc=0.5), f(bh, t, n, sc=0.5), f(bh, t, n, sc=0.5)
    w = (torch.sigmoid(f(bh, t, n) - 1.0) if decay is None
         else torch.full((bh, t, n), decay, device="cuda"))
    return r, k, v, w, f(bh, n, sc=0.5), (f(bh, n, n, sc=0.1) if state
                                          else None)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("t", [1, 27, 64, 96])
@pytest.mark.parametrize("state", [False, True])
def test_wkv6_kernels(gen, chunked, n, t, state):
    """Each WKV kernel against its plain version (f32 sums in another
    order: 1e-4 sequential, 3e-4 chunked, as the CPU tests)."""
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked
    args = wkv_operands(gen, 6, t, n, state=state)
    if chunked:
        got = wkv6_chunked(*args)
        want = ref.wkv6_chunked_matmul_ref(*args, chunk=32)
        tol = 3e-4
    else:
        got, want, tol = wkv6(*args), ref.wkv6_ref(*args), 1e-4
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=tol, rtol=tol)


@pytest.mark.parametrize("chunked", [False, True])
def test_wkv6_state_handoff_and_in_place_state(gen, chunked):
    """Two calls with the state handed over (written in place into the
    caller's state) equal one call; a decay of 1e-6 stays finite."""
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked
    fn = wkv6_chunked if chunked else wkv6
    r, k, v, w, u, _ = wkv_operands(gen, 4, 96, 64, state=False)
    o_full, s_full = fn(r, k, v, w, u)
    s = torch.zeros_like(s_full)
    o1, _ = fn(*(x[:, :64].contiguous() for x in (r, k, v, w)), u, s,
               out_state=s)
    o2, s2 = fn(*(x[:, 64:].contiguous() for x in (r, k, v, w)), u, s,
                out_state=s)
    assert s2.data_ptr() == s.data_ptr()
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(s, s_full, atol=1e-4, rtol=1e-4)
    r, k, v, w, u, _ = wkv_operands(gen, 4, 64, 16, state=False, decay=1e-6)
    o, s = fn(r, k, v, w, u)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    want_o, want_s = ref.wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(o, want_o, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(s, want_s, atol=1e-3, rtol=1e-3)


def gather_operands(gen, dtype, w, page, n, *, frames=40, max_pages=8):
    """A pool, one table row with a -1 entry, ``n`` positions in random
    order with a repeat and (for n > 4) two past the table's reach."""
    shape = (frames, page, w)
    if dtype == torch.int8:
        pool = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(dtype)
    else:
        pool = torch.randn(shape, generator=gen, device="cuda").mul(50).to(dtype)
    row = torch.randperm(frames, generator=gen, device="cuda")[
        :max_pages].int()
    row[1] = -1
    pos = torch.randint(0, max_pages * page, (n,), generator=gen,
                        device="cuda", dtype=torch.int32)
    pos[-1] = pos[0]
    if n > 4:
        pos[:2] = torch.tensor([max_pages * page + 3, max_pages * page * 5],
                               dtype=torch.int32, device="cuda")
    return pool, row, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("w", [4, 14, 512])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("n", [1, 300])
def test_paged_gather_bit_identical(gen, dtype, w, page, n):
    pool, row, pos = gather_operands(gen, dtype, w, page, n)
    ops.reset_launch_counts()
    got = ops.paged_gather(pool, row, pos, page_size=page)
    assert ops.launch_counts()["paged_gather"] == 1
    want = ref.paged_gather_ref(pool, row, pos, page_size=page)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(ops.paged_gather_coalesced(pool, row, pos,
                                                  page_size=page), want)


def test_paged_gather_strided_frames(gen):
    """A pool whose frames are not adjacent (every other frame of a larger
    pool) and an odd row width take the narrow copy units."""
    pool, row, pos = gather_operands(gen, torch.bfloat16, 7, 8, 257,
                                     frames=80)
    view = pool[::2]
    row = row.clamp(max=39)
    got = ops.paged_gather(view, row, pos, page_size=8)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.paged_gather_ref(view, row, pos, page_size=8))


@pytest.mark.parametrize("m,k,n", [
    (128, 128, 128), (256, 384, 128), (128, 512, 256),
    (100, 70, 50), (1, 128, 128), (8, 1024, 8),
    (45, 45, 45), (90, 90, 90), (181, 181, 181),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul(gen, m, k, n, dtype, out_dtype):
    """f32 sums in another order: within 1e-4 of the largest output; a bf16
    output within four bf16 steps of it."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    y = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    ops.reset_launch_counts()
    got = ops.matmul(x, y, out_dtype=out_dtype)
    assert ops.launch_counts()["matmul"] == 1
    want = ref.matmul_ref(x, y, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    peak = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= (1e-4 if out_dtype == torch.float32 else 4 * 2**-8) * peak
