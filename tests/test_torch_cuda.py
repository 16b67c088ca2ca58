"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs a CUDA card and ``nvcc`` and skips with a
reason anywhere else (the CPU tests hold the plain versions against the
JAX package; these hold the kernels against the plain versions).  Run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 (both sides accumulate in f32 in different orders);
bf16 2e-2 (outputs round to bf16, one ulp is 2^-8 relative), and for the
continuation attention and the tensor-core routes four bf16 steps of the
largest output (``4 * 2^-8 * max|want|``); the integer-valued layout
probes of the tensor-core routes are exact; the copies are bit-identical on the whole pool;
the WKV recurrences (f32) 1e-4 sequential and 3e-4 chunked, 1e-3 at a
decay of 1e-6, as their CPU tests against the Pallas kernels;
``ragged_dot`` f32 1e-5 of each row's largest output (an f32 dot over up
to 1,024 terms), bf16 four bf16 steps of each row's largest output; the
RG-LRU's step route 1e-5 of each row's largest |h| (exact bf16 products
summed in f32 in another order than the plain version's), its scan route
bit-identical.
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_copy import ROUTES as COPY_ROUTES
from repro_torch.kernels.paged_gather import ROUTES as GATHER_ROUTES
from repro_torch.kernels.rglru import STEP_TOL

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
    (torch.float32, 4, 2, 14), (torch.bfloat16, 28, 4, 128),
    (torch.bfloat16, 16, 8, 64)])
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
    (torch.float32, 2, 2, 14, 4), (torch.bfloat16, 4, 7, 128, 16),
    (torch.bfloat16, 8, 2, 64, 16)])
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


def rand_like_kv(gen, shape, dtype):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)
    return torch.randn(shape, generator=gen, device="cuda").mul(50).to(dtype)


def assert_pair_copy(srcs, pools, table, starts, lens, page, route):
    """One pair launch on ``route`` into ``pools`` (views kept as given),
    both random-filled pools bit-identical over their whole extent to two
    plain calls on copies."""
    name = "paged_copy" if starts is None else "paged_copy_at"
    ops.reset_launch_counts()
    got = pools
    want = [p.clone() for p in pools]
    if starts is None:
        ops.paged_copy_kv(*srcs, *got, table, lens, page_size=page)
        for src, pool in zip(srcs, want):
            ref.paged_copy_ref(src, pool, table, lens, page_size=page)
    else:
        ops.paged_copy_kv_at(*srcs, *got, table, starts, lens,
                             page_size=page)
        for src, pool in zip(srcs, want):
            ref.paged_copy_at_ref(src, pool, table, starts, lens,
                                  page_size=page)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()[name] == 1
    assert ops.route_counts()[name] == {**dict.fromkeys(COPY_ROUTES, 0),
                                        route: 1}


def pair_case(gen, dtype, page, *, at, zero=False):
    """Five rows of S = 2 page + 3 (not a multiple of the page), W 512:
    lens S, 1, a partial tail, 0 and S - 1 (all 0 with ``zero``); a -1
    entry in row 2; for the continuation copy, starts mid-page, aligned, 0
    and near the end of the table, so row 4 runs past it."""
    b, s, w = 5, 2 * page + 3, 512
    maxp = 4 if at else 3
    frames = b * maxp + 3
    srcs = [rand_like_kv(gen, (b, s, w), dtype) for _ in range(2)]
    pools = [rand_like_kv(gen, (frames, page, w), dtype) for _ in range(2)]
    table = torch.randperm(frames, generator=gen, device="cuda").int()[
        : b * maxp].view(b, maxp).contiguous()
    table[2, 1] = -1
    lens = [0] * b if zero else [s, 1, page + 5, 0, s - 1]
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    starts = None
    if at:
        starts = torch.tensor([page // 2 + 1, page, 3, 0, 3 * page - 2],
                              dtype=torch.int32, device="cuda")
    return srcs, pools, table, starts, lens


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("at", [False, True])
@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_copy_pair_bit_identical(gen, dtype, page, at, zero):
    """Both pair forms on the burst route: partial tail pages, an unmapped
    page, a 1-token chunk, an empty row, unaligned starts ending mid-page,
    a row past the table, and ``lens`` all 0."""
    srcs, pools, table, starts, lens = pair_case(gen, dtype, page, at=at,
                                                 zero=zero)
    assert_pair_copy(srcs, pools, table, starts, lens, page, "burst")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_copy_pair_today_cases(gen, dtype):
    """The single-tensor card tests' cases through the pair forms."""
    b, s, w, page = 4, 37, 512, 16
    srcs = [rand_like_kv(gen, (b, s, w), dtype) for _ in range(2)]
    pools = [rand_like_kv(gen, (20, page, w), dtype) for _ in range(2)]
    table = torch.randperm(20, generator=gen, device="cuda").int()[
        : b * 3].view(b, 3).contiguous()
    table[3, 1:] = -1
    lens = torch.tensor([37, 16, 1, 9], dtype=torch.int32, device="cuda")
    assert_pair_copy(srcs, pools, table, None, lens, page, "burst")
    b, maxp = 5, 6
    srcs = [rand_like_kv(gen, (b, s, w), dtype) for _ in range(2)]
    pools = [rand_like_kv(gen, (40, page, w), dtype) for _ in range(2)]
    table = torch.randperm(40, generator=gen, device="cuda").int()[
        : b * maxp].view(b, maxp).contiguous()
    table[3, 2] = -1
    starts = torch.tensor([5, 32, 77, 20, 70], dtype=torch.int32,
                          device="cuda")
    lens = torch.tensor([37, 16, 1, 30, 37], dtype=torch.int32, device="cuda")
    assert_pair_copy(srcs, pools, table, starts, lens, page, "burst")


@pytest.mark.parametrize("at", [False, True])
def test_paged_copy_pair_serve_shape(gen, at):
    """The serve path's shapes: the cold prefill's src [4, 368, 512] bf16
    (1,092 tokens, 72 frames) and the fork's [3, 240, 512] at start 200."""
    page, w, dt = 16, 512, torch.bfloat16
    if not at:
        b, s, frames, maxp, starts = 4, 368, 72, 36, None
        lens = [368, 290, 250, 184]
        first = [0] * b
    else:
        b, s, frames, maxp = 3, 240, 64, 36
        starts = torch.full((b,), 200, dtype=torch.int32, device="cuda")
        lens = [238, 108, 118]
        first = [200] * b
    srcs = [rand_like_kv(gen, (b, s, w), dt) for _ in range(2)]
    pools = [rand_like_kv(gen, (frames, page, w), dt) for _ in range(2)]
    perm = torch.randperm(frames - 1, generator=gen, device="cuda").int()
    table = torch.full((b, maxp), -1, dtype=torch.int32, device="cuda")
    used = 0
    for i, (x, n) in enumerate(zip(first, lens)):
        lo, hi = x // page, -(-(x + n) // page)
        table[i, lo:hi] = perm[used: used + hi - lo]
        used += hi - lo
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    assert_pair_copy(srcs, pools, table, starts, lens, page, "burst")


@pytest.mark.parametrize("view", ["strided_src", "strided_pool",
                                  "misaligned_src", "misaligned_pool"])
@pytest.mark.parametrize("at", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_copy_pair_general_route(gen, dtype, at, view):
    """Rows apart in src or in the frame, or a base one element past a
    16-byte boundary: the rows route, still bit-identical."""
    srcs, pools, table, starts, lens = pair_case(gen, dtype, 8, at=at)
    b, s, w = srcs[0].shape
    if view == "strided_src":
        srcs = [torch.cat([x, x[..., :8]], -1)[..., :w] for x in srcs]
    elif view == "strided_pool":
        pools = [torch.cat([p, p[..., :8]], -1)[..., :w] for p in pools]
    elif view == "misaligned_src":
        srcs = [torch.cat([x.flatten()[:1], x.flatten()])[1:].view(b, s, w)
                for x in srcs]
    else:
        pools = [torch.cat([p.flatten()[:1], p.flatten()])[1:].view(p.shape)
                 for p in pools]
    assert_pair_copy(srcs, pools, table, starts, lens, 8, "rows")


@pytest.mark.parametrize("at", [False, True])
def test_paged_copy_single_forms_take_the_burst_route(gen, at):
    """The single-tensor wrappers launch the same kernel with one pair and
    count under the same counters."""
    srcs, pools, table, starts, lens = pair_case(gen, torch.bfloat16, 16,
                                                 at=at)
    ops.reset_launch_counts()
    got, want = pools[0].clone(), pools[0].clone()
    if starts is None:
        ops.paged_copy(srcs[0], got, table, lens, page_size=16)
        ref.paged_copy_ref(srcs[0], want, table, lens, page_size=16)
    else:
        ops.paged_copy_at(srcs[0], got, table, starts, lens, page_size=16)
        ref.paged_copy_at_ref(srcs[0], want, table, starts, lens,
                              page_size=16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    name = "paged_copy" if starts is None else "paged_copy_at"
    assert ops.route_counts()[name] == {"burst": 1, "rows": 0}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,hkv,g,d,page", [
    (torch.float32, 2, 2, 14, 4), (torch.bfloat16, 4, 7, 128, 16),
    (torch.bfloat16, 8, 2, 64, 16)])
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


#: a per-channel mix of extreme decays, repeated over the channels
MIXED_DECAYS = (1e-6, 0.5, 1 - 1e-6, 1.0)


def wkv_operands(gen, bh, t, n, *, state, decay=None):
    """f32 r, k, v (scale 0.5), w = sigmoid(z - 1), a constant decay or
    (``decay="mixed"``) the per-channel :data:`MIXED_DECAYS`, u, and an
    optional state (scale 0.1), contiguous on the card."""
    def f(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * sc
    r, k, v = f(bh, t, n, sc=0.5), f(bh, t, n, sc=0.5), f(bh, t, n, sc=0.5)
    if decay is None:
        w = torch.sigmoid(f(bh, t, n) - 1.0)
    elif decay == "mixed":
        row = torch.tensor(MIXED_DECAYS, device="cuda").repeat(n // 4)
        w = row.expand(bh, t, n).contiguous()
    else:
        w = torch.full((bh, t, n), decay, device="cuda")
    return r, k, v, w, f(bh, n, sc=0.5), (f(bh, n, n, sc=0.1) if state
                                          else None)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("t", [1, 17, 27, 33, 64, 96, 512])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("bh", [6, 1])
def test_wkv6_kernels(gen, chunked, n, t, state, bh):
    """Each WKV kernel against its plain version (f32 sums in another
    order: 1e-4 sequential, 3e-4 chunked, as the CPU tests), at every head
    size the kernels take (their tiles change with it), at one head and
    six, and at one step past a stage of the sequential kernel (T = 17, 33:
    its stages are 16 steps) and of a chunk (T = 33)."""
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked
    args = wkv_operands(gen, bh, t, n, state=state)
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
    # the per-channel extreme decays, handed over at an unaligned split
    r, k, v, w, u, s0 = wkv_operands(gen, 4, 96, 64, state=True,
                                     decay="mixed")
    o_full, s_full = fn(r, k, v, w, u, s0)
    assert torch.isfinite(o_full).all() and torch.isfinite(s_full).all()
    s = s0.clone()
    o1, _ = fn(*(x[:, :40].contiguous() for x in (r, k, v, w)), u, s,
               out_state=s)
    o2, _ = fn(*(x[:, 40:].contiguous() for x in (r, k, v, w)), u, s,
               out_state=s)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(s, s_full, atol=1e-4, rtol=1e-4)
    want_o, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o_full, want_o, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(s_full, want_s, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("t", [64, 512])
def test_wkv6_kernels_extreme_decays(gen, chunked, n, t):
    """The per-channel decays {1e-6, 0.5, 1 - 1e-6, 1} with a state: finite,
    within each kernel's tolerance of its plain version (1e-4 sequential,
    3e-4 chunked) and within 1e-3 of the step loop (the chunked form takes
    a decay of 1e-6 as an exp of a cumsum of logs)."""
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked
    args = wkv_operands(gen, 6, t, n, state=True, decay="mixed")
    if chunked:
        got = wkv6_chunked(*args)
        plain = ref.wkv6_chunked_matmul_ref(*args, chunk=32)
        tol = 3e-4
    else:
        got, plain, tol = wkv6(*args), ref.wkv6_ref(*args), 1e-4
    step = ref.wkv6_ref(*args)
    for g_, p_, s_ in zip(got, plain, step):
        assert torch.isfinite(g_).all()
        torch.testing.assert_close(g_, p_, atol=tol, rtol=tol)
        torch.testing.assert_close(g_, s_, atol=1e-3, rtol=1e-3)


def test_wkv6_launch_shape_and_alignment(gen):
    """The sequential kernel's launch shape: at least one block resident a
    SM at every head size, and at N = 64 (the serve path's) 64 threads
    (8 x 8 state tiles) and at least four blocks a SM, so 512 heads run in
    one wave on 132 SMs; a view of r, k, v, w or a state that is not
    16-byte aligned is refused before the launch, and by the C launcher."""
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv6 import HEAD_SIZES, launch_config, wkv6
    for n in HEAD_SIZES:
        cfg = launch_config(n)
        assert cfg["blocks_per_sm"] >= 1, (n, cfg)
    cfg = launch_config(64)
    assert cfg["threads"] == 64 and cfg["blocks_per_sm"] >= 4, cfg
    args = list(wkv_operands(gen, 2, 33, 16, state=True))
    before = wkv6.launches
    for i in (0, 1, 2, 3, 5):
        shifted = torch.empty(args[i].numel() + 1, device="cuda")[1:]
        shifted = shifted.view(args[i].shape).copy_(args[i])
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        bad = args[:i] + [shifted] + args[i + 1:]
        with pytest.raises(ValueError, match="aligned"):
            wkv6(*bad)
    # the C launcher refuses one too (cudaErrorMisalignedAddress, 716)
    r = args[0]
    o = torch.empty_like(r)
    shifted = torch.empty(r.numel() + 1, device="cuda")[1:].view(r.shape)
    err = build.launcher("wkv6")(
        shifted.data_ptr(), *(x.data_ptr() for x in args[1:6]), o.data_ptr(),
        args[5].data_ptr(), r.shape[0], r.shape[1], r.shape[2],
        torch.cuda.current_stream().cuda_stream)
    assert err == 716, err
    with pytest.raises(ValueError, match="aligned"):
        wkv6(*args, out_state=torch.empty(
            args[5].numel() + 1, device="cuda")[1:].view(args[5].shape))
    assert wkv6.launches == before


def test_wkv6_chunked_launch_shape_and_alignment(gen):
    """The chunked kernel's launch shape fits the card (at least one block
    resident a SM at every head size), and a view that is not 16-byte
    aligned is refused before the launch."""
    from repro_torch.kernels.wkv6_chunked import (HEAD_SIZES, launch_config,
                                                  wkv6_chunked)
    for n in HEAD_SIZES:
        cfg = launch_config(n)
        assert cfg["blocks_per_sm"] >= 1, (n, cfg)
    r, k, v, w, u, _ = wkv_operands(gen, 2, 33, 16, state=False)
    shifted = torch.empty(r.numel() + 1, device="cuda")[1:].view(r.shape)
    shifted.copy_(r)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        wkv6_chunked(shifted, k, v, w, u)
    # the states go through the same check (the shared launch)
    bh, _, n = r.shape
    state = torch.zeros(bh * n * n + 1, device="cuda")[1:].view(bh, n, n)
    with pytest.raises(ValueError, match="aligned"):
        wkv6_chunked(r, k, v, w, u, state)


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


def gather_launch(pool, row, pos, page, route):
    """One ``ops.paged_gather`` launch on ``route`` (a literal of the
    caller's), bit-identical to the plain version and to the coalesced
    route."""
    ops.reset_launch_counts()
    got = ops.paged_gather(pool, row, pos, page_size=page)
    assert ops.launch_counts()["paged_gather"] == 1
    assert ops.route_counts()["paged_gather"] == {
        **dict.fromkeys(GATHER_ROUTES, 0), route: 1}
    want = ref.paged_gather_ref(pool, row, pos, page_size=page)
    torch.cuda.synchronize()
    assert got.dtype == pool.dtype and torch.equal(got, want)
    assert torch.equal(ops.paged_gather_coalesced(pool, row, pos,
                                                  page_size=page), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("w,route", [(4, "lanes"), (14, "lanes"),
                                     (512, "bulk")])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("n", [1, 300])
def test_paged_gather_bit_identical(gen, dtype, w, route, page, n):
    pool, row, pos = gather_operands(gen, dtype, w, page, n)
    gather_launch(pool, row, pos, page, route)


#: (dtype, W, route, E): E is the bulk route's batch, 8 KB of rows (at most
#: 32); a lanes case lists the N around 8 alike
GATHER_CASES = [
    (torch.float32, 512, "bulk", 4), (torch.bfloat16, 512, "bulk", 8),
    (torch.int8, 512, "bulk", 16), (torch.float32, 4, "lanes", 8),
    (torch.bfloat16, 4, "lanes", 8), (torch.int8, 4, "lanes", 8),
    (torch.float32, 7, "lanes", 8), (torch.bfloat16, 7, "lanes", 8),
    (torch.int8, 7, "lanes", 8), (torch.float32, 14, "lanes", 8),
    (torch.bfloat16, 14, "lanes", 8), (torch.int8, 14, "lanes", 8),
]


@pytest.mark.parametrize("dtype,w,route,e", GATHER_CASES)
@pytest.mark.parametrize("n", ["1", "e-1", "e", "e+1", "300", "4099",
                               "32768"])
def test_paged_gather_batches_and_clamping(gen, dtype, w, route, e, n):
    """N on each side of the batch and past the bulk grid's stride (396
    blocks of 4 warps at 1 KB rows: 12,672 elements a pass), with every
    clamp: positions past the reach, a -1 entry, negative positions and an
    entry >= P."""
    n = {"1": 1, "e-1": e - 1, "e": e, "e+1": e + 1}.get(n) or int(n)
    pool, row, pos = gather_operands(gen, dtype, w, 16, n)
    row[3] = pool.shape[0] + 5                   # an entry >= P
    if n > 4:
        pos[2] = -1
        pos[n // 2] = -17
    gather_launch(pool, row, pos, 16, route)


@pytest.mark.parametrize("w,route", [(512, "bulk"), (7, "lanes")])
def test_paged_gather_strided_frames(gen, w, route):
    """A pool whose frames are not adjacent (every other frame of a larger
    pool): 16-byte aligned 1 KB rows stay on the bulk route, an odd row
    width takes the narrow copy units."""
    pool, row, pos = gather_operands(gen, torch.bfloat16, w, 8, 257,
                                     frames=80)
    gather_launch(pool[::2], row.clamp(max=39), pos, 8, route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_gather_offset_view_takes_lanes(gen, dtype):
    """A pool view one element off its allocation is not 16-byte aligned:
    the lanes route, at the serve rows' width."""
    pool, row, pos = gather_operands(gen, dtype, 512, 16, 300)
    flat = torch.empty(pool.numel() + 1, dtype=dtype, device="cuda")
    view = flat[1:].view(pool.shape)
    view.copy_(pool)
    assert view.data_ptr() % 16
    gather_launch(view, row, pos, 16, "lanes")


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


def bf16_steps(got, want, steps=4):
    """``max|got - want| <= steps * 2^-8 * max|want|``."""
    err = float((got.float() - want.float()).abs().max())
    peak = float(want.float().abs().max())
    assert err <= steps * 2**-8 * peak, (err, peak)


@pytest.mark.parametrize("m,k,n,route", [
    (1, 4096, 4096, "wgmma"), (129, 200, 264, "wgmma"),
    (2048, 3584, 18944, "wgmma"), (100, 70, 50, "simt")])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul_bf16_routes(gen, m, k, n, route, out_dtype):
    """bf16 operands reach the tensor-core route when TMA can address them
    (ragged M, N and K at (129, 200, 264)), the CUDA-core route when N and
    K are not multiples of 8; f32 output within 1e-4 of the largest
    output, bf16 output within four bf16 steps."""
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    y = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
    ops.reset_launch_counts()
    got = ops.matmul(x, y, out_dtype=out_dtype)
    assert ops.route_counts()["matmul"] == {**{"wgmma": 0, "simt": 0},
                                            route: 1}
    want = ref.matmul_ref(x, y, out_dtype)
    torch.cuda.synchronize()
    if out_dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())
    else:
        bf16_steps(got, want)


@pytest.mark.parametrize("m,k,n", [(200, 136, 520), (64, 64, 256),
                                   (300, 1000, 72)])
def test_matmul_wgmma_exact_layout_probe(gen, m, k, n):
    """Small integers in bf16 make every product and sum exact, so a wrong
    swizzle, descriptor offset or fragment map shows as a mismatch, not as
    noise: the tensor-core route must equal the f32 product exactly."""
    x = torch.randint(-8, 9, (m, k), generator=gen, device="cuda").bfloat16()
    y = torch.randint(-8, 9, (k, n), generator=gen, device="cuda").bfloat16()
    ops.reset_launch_counts()
    got = ops.matmul(x, y, out_dtype=torch.float32)
    assert ops.route_counts()["matmul"]["wgmma"] == 1
    assert torch.equal(got, x.float() @ y.float())


def test_matmul_simt_f32_tiles(gen):
    """f32 takes the CUDA-core route at every tile size (n = 45 and 181
    get small tiles, 1536 the largest), within 1e-4 of the largest output,
    and a misaligned view takes it too."""
    for n in (45, 181, 1536):
        x = torch.randn((n, n), generator=gen, device="cuda")
        y = torch.randn((n, n), generator=gen, device="cuda")
        ops.reset_launch_counts()
        got = ops.matmul(x, y)
        assert ops.route_counts()["matmul"] == {"wgmma": 0, "simt": 1}
        want = ref.matmul_ref(x, y)
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
    base = torch.randn(64 * 72 + 1, generator=gen, device="cuda").bfloat16()
    x = base[1:].view(64, 72)
    y = torch.randn((72, 128), generator=gen, device="cuda").bfloat16()
    ops.reset_launch_counts()
    got = ops.matmul(x, y, out_dtype=torch.float32)
    assert ops.route_counts()["matmul"]["simt"] == 1
    want = ref.matmul_ref(x, y, torch.float32)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


#: (m, k, n, dtype, tile, vec) reaching every instantiation of the
#: CUDA-core kernel on a 132-SM H100 (as ``test_torch_routes.SIMT_CASES``)
SIMT_CASES = [
    (128, 128, 128, torch.float32, 16, True),
    (181, 181, 181, torch.float32, 16, False),
    (384, 384, 384, torch.float32, 32, True),
    (384, 383, 384, torch.float32, 32, False),
    (1024, 1024, 1024, torch.float32, 64, True),
    (1024, 1022, 1024, torch.float32, 64, False),
    (1536, 1536, 1536, torch.float32, 128, True),
    (1536, 1534, 1536, torch.float32, 128, False),
    (100, 70, 50, torch.bfloat16, 16, False),
    (384, 383, 384, torch.bfloat16, 32, False),
    (1000, 1002, 1002, torch.bfloat16, 64, False),
    (1536, 1534, 1536, torch.bfloat16, 128, False),
]


@pytest.mark.parametrize("m,k,n,dtype,tile,vec", SIMT_CASES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul_simt_tiles(gen, m, k, n, dtype, tile, vec, out_dtype):
    """Each tile size of the CUDA-core route, with and without 16-byte
    copies, for both operand and output types, on this card's SM count:
    f32 output within 1e-4 of the largest output, bf16 output within four
    bf16 steps."""
    from repro_torch.kernels.matmul import simt_config
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    y = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms != 132:
        pytest.skip(f"the cases pick tiles for 132 SMs, this card has {sms}")
    assert simt_config(x, y, sms) == (tile, vec)
    ops.reset_launch_counts()
    got = ops.matmul(x, y, out_dtype=out_dtype)
    assert ops.route_counts()["matmul"] == {"wgmma": 0, "simt": 1}
    want = ref.matmul_ref(x, y, out_dtype)
    torch.cuda.synchronize()
    if out_dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())
    else:
        bf16_steps(got, want)


def serve_views(gen, b, sq, sk, hq, hkv, d):
    """bf16 q/k/v as the serve path passes them: ``[B, S, H, D]`` memory
    seen as ``[B, H, S, D]``."""
    def t(s, h):
        return torch.randn((b, s, h, d), generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)
    return t(sq, hq), t(sk, hkv), t(sk, hkv)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 368, 1000])
@pytest.mark.parametrize("hq,hkv", [(28, 4), (4, 4)])
def test_flash_attention_wgmma(gen, s, hq, hkv):
    """The serve path's views take the tensor-core route at every length
    around the 64- and 128-row tiles and on ragged tails, within four bf16
    steps of the plain version."""
    q, k, v = serve_views(gen, 2, s, s, hq, hkv, 128)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    assert ops.route_counts()["flash_attention"] == {"wgmma": 1, "simt": 0}
    bf16_steps(got, ref.flash_attention_ref(q, k, v))


@pytest.mark.parametrize("sq,sk,d,causal", [
    (100, 300, 128, True), (130, 130, 64, True), (77, 200, 80, False)])
def test_flash_attention_wgmma_shapes(gen, sq, sk, d, causal):
    """Sq < Sk (the diagonal anchored at the end), D = 64 and a D of 80
    padded to 128 by the zero fill, contiguous ``[B, H, S, D]`` views and
    a non-causal call."""
    q = torch.randn((2, 8, sq, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((2, 2, sk, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((2, 2, sk, d), generator=gen, device="cuda").bfloat16()
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.route_counts()["flash_attention"]["wgmma"] == 1
    bf16_steps(got, ref.flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("sq,sk", [(200, 200), (65, 300)])
def test_flash_attention_wgmma_exact_layout_probe(gen, sq, sk):
    """Every query row picks one visible key: q and k are pairs of one-hot
    entries of 64 (``j % 64`` and ``64 + j // 64``), so the chosen key
    scores 256 and every other at most 128; with scale 1 the others'
    weights (e^-128) underflow to zero in f32 and the output is that key's
    value row, exactly, for integer-valued v.  A wrong Q/K layout picks the
    wrong key, a wrong P or V layout moves the values."""
    b, hq, hkv, d, big = 2, 8, 2, 128, 128.0
    g = hq // hkv
    offset = sk - sq
    j = torch.randint(0, 1 << 30, (b, hq, sq), generator=gen, device="cuda")
    rows = torch.arange(sq, device="cuda")
    j = j % (rows + offset + 1)                       # a visible key per row
    q = torch.zeros((b, sq, hq, d), device="cuda")
    bi, hi, ri = torch.meshgrid(torch.arange(b, device="cuda"),
                                torch.arange(hq, device="cuda"), rows,
                                indexing="ij")
    q[bi, ri, hi, j % 64] = big
    q[bi, ri, hi, 64 + j // 64] = big
    keys = torch.arange(sk, device="cuda")
    k = torch.zeros((b, sk, hkv, d), device="cuda")
    k[:, keys, :, keys % 64] = 1.0
    k[:, keys, :, 64 + keys // 64] = 1.0
    v = torch.randint(-100, 101, (b, sk, hkv, d), generator=gen,
                      device="cuda").float()
    qt, kt, vt = (t.bfloat16().transpose(1, 2) for t in (q, k, v))
    ops.reset_launch_counts()
    got = ops.flash_attention(qt, kt, vt, scale=1.0)
    assert ops.route_counts()["flash_attention"]["wgmma"] == 1
    want = vt[bi, hi // g, j]                        # [B, Hq, Sq, D]
    assert torch.equal(ref.flash_attention_ref(qt, kt, vt, scale=1.0), want)
    assert torch.equal(got, want)


def test_flash_attention_misaligned_view_takes_simt(gen):
    """A bf16 view whose base is not 16-byte aligned takes the CUDA-core
    route, within four bf16 steps."""
    b, s, h, d = 1, 70, 4, 128
    base = torch.randn(b * s * h * d + 1, generator=gen,
                       device="cuda").bfloat16()
    q = base[1:].view(b, s, h, d).transpose(1, 2)
    k = torch.randn((b, h, s, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, h, s, d), generator=gen, device="cuda").bfloat16()
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    assert ops.route_counts()["flash_attention"] == {"wgmma": 0, "simt": 1}
    bf16_steps(got, ref.flash_attention_ref(q, k, v))


# ---------------------------------------------------------------------------
# the tensor-core routes of the paged attention kernels
# ---------------------------------------------------------------------------


def rows_within(got, want, tol=4 * 2**-8, lead=False):
    """Every output row within ``tol`` (four bf16 steps by default) of that
    row's largest value (a row that averages many keys is far smaller than
    one that sees a few).  A row is the last dim ``[..., D]``, or with
    ``lead`` dim 0 with every other dim flattened."""
    got, want = got.float(), want.float()
    if lead:
        got, want = got.flatten(1), want.flatten(1)
    diff = (got - want).abs().amax(-1)
    peak = want.abs().amax(-1)
    bad = diff > tol * peak
    assert not bool(bad.any()), (float(diff.max()), int(bad.sum()))


def pools(gen, frames, page, hkv, d, quant):
    shape = (frames, page, hkv, d)
    if quant:
        return tuple(torch.randint(-127, 128, shape, generator=gen,
                                   device="cuda", dtype=torch.int32)
                     .to(torch.int8) for _ in range(2))
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                 for _ in range(2))


def mapped_table(gen, b, maxp, frames, n_pages):
    """Distinct shuffled frames for each row's first ``n_pages[i]`` pages,
    -1 beyond."""
    perm = torch.randperm(frames, generator=gen, device="cuda").int()
    table = torch.full((b, maxp), -1, dtype=torch.int32, device="cuda")
    for i, n in enumerate(n_pages):
        table[i, :n] = perm[i * maxp: i * maxp + n]
    return table


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page", [8, 16, 32, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 7, 8, 16])
def test_paged_decode_attention_mma(gen, quant, page, d, g):
    """The tensor-core route at every G up to 16, D 64 and 128, pages of
    8-64, bf16 and int8 pools: ragged lengths, an empty sequence, a
    1-token sequence, a full table, -1 entries past each sequence's pages,
    with and without a window; each output row within four bf16 steps of
    its largest value."""
    b, hkv, maxp = 5, 2, 12
    frames = b * maxp
    lens = [page * 5 + 3, 0, 1, page * maxp, 2 * page]
    q = torch.randn((b, hkv, g, d), generator=gen, device="cuda").bfloat16()
    kp, vp = pools(gen, frames, page, hkv, d, quant)
    table = mapped_table(gen, b, maxp, frames, [-(-n // page) for n in lens])
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kvs = 1 / 24 if quant else None
    for window in (None, page + 2):
        ops.reset_launch_counts()
        got = ops.paged_decode_attention(q, kp, vp, table, sl, page_size=page,
                                         window=window, kv_scale=kvs)
        assert ops.route_counts()["paged_decode_attention"] == {
            "mma": 1, "simt": 0}
        want = ref.paged_decode_attention_ref(q, kp, vp, table, sl,
                                              page_size=page, window=window,
                                              kv_scale=kvs)
        torch.cuda.synchronize()
        rows_within(got, want)
        assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_attention_mma_d80_and_repeats(gen, quant):
    """D = 80 (a multiple of 16, on the tensor-core route) at the serve
    batch, and 20 calls in a row at lengths that move every split's page
    range, including empty sequences."""
    b, hkv, g, d, page, maxp = 4, 4, 7, 80, 16, 36
    frames = b * maxp
    q = torch.randn((b, hkv, g, d), generator=gen, device="cuda").bfloat16()
    kp, vp = pools(gen, frames, page, hkv, d, quant)
    kvs = 1 / 24 if quant else None
    for step in range(20):
        lens = [(37 * step + 11 * i) % (page * maxp) for i in range(b)]
        table = mapped_table(gen, b, maxp, frames,
                             [-(-n // page) for n in lens])
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ops.reset_launch_counts()
        got = ops.paged_decode_attention(q, kp, vp, table, sl, page_size=page,
                                         kv_scale=kvs)
        assert ops.route_counts()["paged_decode_attention"]["mma"] == 1
        rows_within(got, ref.paged_decode_attention_ref(
            q, kp, vp, table, sl, page_size=page, kv_scale=kvs))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page", [8, 16, 32, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 7, 8, 16])
def test_paged_prefill_attention_wgmma(gen, quant, page, d, g):
    """The tensor-core route at every G up to 16, D 64 and 128, pages of
    8-64, bf16 and int8 pools: a mid-page start with a chunk longer than
    the block (``128 // G`` tokens; S = 150), a page-aligned start with a
    1-token chunk, a zero start, and a row whose chunk runs past the
    table; -1 entries past each row's pages (inside the causal reach of
    its padded rows); q the strided view of the projection."""
    b, hkv, maxp = 4, 2, 8
    frames = b * maxp
    s = 150
    starts_l = [page + 3, 2 * page, 0, maxp * page - 20]
    chunks = [s, 1, 37, 60]
    q = torch.randn((b, s, hkv * g * d), generator=gen,
                    device="cuda").bfloat16().view(b, s, hkv, g, d)
    kp, vp = pools(gen, frames, page, hkv, d, quant)
    table = mapped_table(gen, b, maxp, frames, [
        min(-(-(st + c) // page), maxp) for st, c in zip(starts_l, chunks)])
    starts = torch.tensor(starts_l, dtype=torch.int32, device="cuda")
    kvs = 1 / 24 if quant else None
    ops.reset_launch_counts()
    got = ops.paged_prefill_attention(q, kp, vp, table, starts,
                                      page_size=page, kv_scale=kvs)
    assert ops.route_counts()["paged_prefill_attention"] == {
        "wgmma": 1, "simt": 0}
    want = ref.paged_prefill_attention_ref(q, kp, vp, table, starts,
                                           page_size=page, kv_scale=kvs)
    torch.cuda.synchronize()
    for i, c in enumerate(chunks):
        rows_within(got[i, :c], want[i, :c])


@pytest.mark.parametrize("quant", [False, True])
def test_paged_prefill_attention_wgmma_serve_shape_d80(gen, quant):
    """The radix serve shape (G = 7, 18 tokens a block, 240-token chunks
    at start 200) and D = 80 (zero-filled past D by TMA) on the
    tensor-core route."""
    for d in (128, 80):
        b, s, hkv, g, page, maxp = 3, 240, 4, 7, 16, 36
        frames = 64
        starts_l, chunks = [200, 200, 200], [238, 108, 118]
        q = torch.randn((b, s, hkv * g * d), generator=gen,
                        device="cuda").bfloat16().view(b, s, hkv, g, d)
        kp, vp = pools(gen, frames, page, hkv, d, quant)
        perm = torch.randperm(frames, generator=gen, device="cuda").int()
        table = perm[: maxp].repeat(b, 1).contiguous()   # a shared prefix
        starts = torch.tensor(starts_l, dtype=torch.int32, device="cuda")
        kvs = 1 / 24 if quant else None
        ops.reset_launch_counts()
        got = ops.paged_prefill_attention(q, kp, vp, table, starts,
                                          page_size=page, kv_scale=kvs)
        assert ops.route_counts()["paged_prefill_attention"]["wgmma"] == 1
        want = ref.paged_prefill_attention_ref(q, kp, vp, table, starts,
                                               page_size=page, kv_scale=kvs)
        for i, c in enumerate(chunks):
            rows_within(got[i, :c], want[i, :c])


def test_paged_attention_simt_routes_still_launch(gen):
    """f32 operands and a misaligned bf16 view launch the CUDA-core
    kernels of both paged attention wrappers, within their tolerances."""
    b, hkv, g, maxp = 2, 2, 2, 6
    frames = b * maxp
    for dtype in (torch.float32, torch.bfloat16):
        # f32 at the reduced shape; bf16 at a shape the tensor cores take,
        # but with q one element off a 16-byte boundary
        dd, page = (14, 4) if dtype == torch.float32 else (128, 16)
        base = torch.randn(b * hkv * g * dd + 1, generator=gen,
                           device="cuda").to(dtype)
        q = base[:-1].view(b, hkv, g, dd) if dtype == torch.float32 \
            else base[1:].view(b, hkv, g, dd)
        kp = torch.randn((frames, page, hkv, dd), generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn((frames, page, hkv, dd), generator=gen,
                         device="cuda").to(dtype)
        lens = [13, 22]
        table = mapped_table(gen, b, maxp, frames, [-(-n // page)
                                                    for n in lens])
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ops.reset_launch_counts()
        got = ops.paged_decode_attention(q, kp, vp, table, sl, page_size=page)
        assert ops.route_counts()["paged_decode_attention"] == {
            "mma": 0, "simt": 1}
        want = ref.paged_decode_attention_ref(q, kp, vp, table, sl,
                                              page_size=page)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        else:
            rows_within(got, want)
        s = 9
        qbase = torch.randn(b * s * hkv * g * dd + 8, generator=gen,
                            device="cuda").to(dtype)
        qp = qbase[1: 1 + b * s * hkv * g * dd].view(b, s, hkv, g, dd)
        starts = torch.tensor([3, 10], dtype=torch.int32, device="cuda")
        ops.reset_launch_counts()
        got = ops.paged_prefill_attention(qp, kp, vp, table, starts,
                                          page_size=page)
        assert ops.route_counts()["paged_prefill_attention"] == {
            "wgmma": 0, "simt": 1}
        want = ref.paged_prefill_attention_ref(qp, kp, vp, table, starts,
                                               page_size=page)
        chunks = [9, 9]
        for i, c in enumerate(chunks):
            if dtype == torch.float32:
                torch.testing.assert_close(got[i, :c], want[i, :c],
                                           atol=1e-5, rtol=1e-5)
            else:
                rows_within(got[i, :c], want[i, :c])


def one_hot_keys(pos, big):
    """``[N, 128]`` rows with ``big`` at ``pos % 64`` and ``64 + pos //
    64``: two such rows score ``2 big^2`` when equal and at most ``big^2``
    otherwise (positions < 4096)."""
    x = torch.zeros((pos.numel(), 128), device="cuda")
    idx = torch.arange(pos.numel(), device="cuda")
    x[idx, pos % 64] = big
    x[idx, 64 + pos // 64] = big
    return x


def probe_pools(gen, frames, page, hkv, maxp, b, quant):
    """K rows one-hot by logical position (1.0 after dequantization: int8
    24 at kv_scale 1/24), V integer-valued; the table maps logical page p
    of row i to a frame from a shuffled order and moves page 1 of row 0
    to the last frame."""
    kvs = 1 / 24 if quant else None
    perm = torch.randperm(frames, generator=gen, device="cuda").int()
    table = perm[: b * maxp].view(b, maxp).contiguous()
    last = frames - 1
    where = (table == last).nonzero()
    if where.numel():
        table[where[0, 0], where[0, 1]] = table[0, 1]
    table[0, 1] = last
    kp = torch.zeros((frames, page, hkv, 128), device="cuda")
    for i in range(b):
        pos = torch.arange(maxp * page, device="cuda")
        rows = one_hot_keys(pos, 1.0)
        fr = table[i].long()[pos // page]
        for h in range(hkv):
            kp[fr, pos % page, h] = rows
    vp = torch.randint(-100, 101, (frames, page, hkv, 128), generator=gen,
                       device="cuda").float()
    if quant:
        return (kp * 24).to(torch.int8), vp.to(torch.int8), table, kvs
    return kp.bfloat16(), vp.bfloat16(), table, kvs


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_attention_mma_exact_layout_probe(gen, quant):
    """Every query head picks one visible key: q is one-hot pairs of 128
    at the chosen position, so with scale 1 the chosen key scores 256 and
    every other at most 128; the others' weights (e^-128) vanish in f32
    and the output is that key's value row, exactly.  Heads of a group
    pick different keys (a wrong head row or key column picks the wrong
    row, a wrong V fragment moves values); one head of row 0 picks a key
    on logical page 1, which lives in the pool's last frame."""
    b, hkv, g, page, maxp = 3, 2, 7, 16, 20
    frames = b * maxp
    kp, vp, table, kvs = probe_pools(gen, frames, page, hkv, maxp, b, quant)
    lens = torch.tensor([300, 100, 17], dtype=torch.int32, device="cuda")
    j = torch.randint(0, 1 << 30, (b, hkv, g), generator=gen, device="cuda")
    j = j % lens.long()[:, None, None]
    j[0, 0, 0] = page + 5                          # page 1 -> the last frame
    assert int(table[0, 1]) == frames - 1
    q = one_hot_keys(j.flatten(), 128.0).view(b, hkv, g, 128).bfloat16()
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, kp, vp, table, lens, page_size=page,
                                     scale=1.0, kv_scale=kvs)
    assert ops.route_counts()["paged_decode_attention"]["mma"] == 1
    want = ref.paged_decode_attention_ref(q, kp, vp, table, lens,
                                          page_size=page, scale=1.0,
                                          kv_scale=kvs)
    bi = torch.arange(b, device="cuda")[:, None, None]
    hi = torch.arange(hkv, device="cuda")[None, :, None]
    fr = table.long()[bi, j // page]
    v = vp[fr, j % page, hi]
    v = (v.float() * kvs).bfloat16() if quant else v
    assert torch.equal(want, v)
    assert torch.equal(got, v)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_prefill_attention_wgmma_exact_layout_probe(gen, quant):
    """As the decode probe, for the continuation chunk: every (token,
    head) row picks one key it can causally see, at a mid-page start over
    several 128-key tiles, with row 0's first token on the scrambled page
    1; 18-token blocks at G = 7 put rows 126-127 of each block in
    padding."""
    b, s, hkv, g, page, maxp = 2, 40, 2, 7, 16, 20
    frames = b * maxp
    kp, vp, table, kvs = probe_pools(gen, frames, page, hkv, maxp, b, quant)
    starts = torch.tensor([250, 21], dtype=torch.int32, device="cuda")
    reach = starts.long()[:, None] + torch.arange(s, device="cuda") + 1
    j = torch.randint(0, 1 << 30, (b, s, hkv, g), generator=gen,
                      device="cuda") % reach[:, :, None, None]
    j[0, 0, 0, 0] = page + 5
    assert int(table[0, 1]) == frames - 1
    q = one_hot_keys(j.flatten(), 128.0).view(b, s, hkv, g, 128).bfloat16()
    ops.reset_launch_counts()
    got = ops.paged_prefill_attention(q, kp, vp, table, starts,
                                      page_size=page, scale=1.0, kv_scale=kvs)
    assert ops.route_counts()["paged_prefill_attention"]["wgmma"] == 1
    want = ref.paged_prefill_attention_ref(q, kp, vp, table, starts,
                                           page_size=page, scale=1.0,
                                           kv_scale=kvs)
    bi = torch.arange(b, device="cuda")[:, None, None, None]
    hi = torch.arange(hkv, device="cuda")[None, None, :, None]
    fr = table.long()[bi, j // page]
    v = vp[fr, j % page, hi]
    v = (v.float() * kvs).bfloat16() if quant else v
    assert torch.equal(want, v)
    assert torch.equal(got, v)


@pytest.mark.parametrize("b,hkv", [(40, 8), (33, 4), (12, 4), (4, 4), (1, 1)])
def test_paged_decode_attention_mma_cluster_sizes(gen, b, hkv):
    """Batches whose split plan gives clusters of 1, 2, 6 and 8 splits
    (the plan's 12 and 36 capped at 8) on a 132-SM card, each sequence's
    pages cut over its own cluster."""
    from repro_torch.kernels.paged_attention import MMA_SPLITS_MAX, split_plan
    g, d, page, maxp = 7, 128, 16, 36
    frames = b * maxp
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_split = min(split_plan(b, hkv, maxp, page, sms, d)[1], MMA_SPLITS_MAX)
    q = torch.randn((b, hkv, g, d), generator=gen, device="cuda").bfloat16()
    kp, vp = pools(gen, frames, page, hkv, d, False)
    lens = [(97 * i + 5) % (page * maxp) for i in range(b)]
    table = mapped_table(gen, b, maxp, frames, [-(-n // page) for n in lens])
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, kp, vp, table, sl, page_size=page)
    assert ops.route_counts()["paged_decode_attention"]["mma"] == 1
    rows_within(got, ref.paged_decode_attention_ref(q, kp, vp, table, sl,
                                                    page_size=page))
    assert 1 <= n_split <= MMA_SPLITS_MAX


# ---------------------------------------------------------------------------
# CUDA graphs: each serve kernel captured alone and replayed, and the reduced
# engine's step programs against ``disable_graphs()`` runs
# ---------------------------------------------------------------------------


def captured(fn):
    """Warm ``fn`` up on a side stream, then capture it as a CUDA graph;
    returns ``(graph, output)``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.parametrize("at", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_graph_replay_pair_copy_bit_identical(gen, dtype, at):
    """Both pair copies (a programmatic dependent launch) replayed from a
    graph write the whole pools bit-identical to their eager launch."""
    srcs, pools_, table, starts, lens = pair_case(gen, dtype, 16, at=at)
    init = [p.clone() for p in pools_]
    eager = [p.clone() for p in pools_]

    def copy(dst):
        if starts is None:
            return ops.paged_copy_kv(*srcs, *dst, table, lens, page_size=16)
        return ops.paged_copy_kv_at(*srcs, *dst, table, starts, lens,
                                    page_size=16)

    copy(eager)
    graph, _ = captured(lambda: copy(pools_))
    for p, i in zip(pools_, init):
        p.copy_(i)                    # the warm-up wrote them
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pools_, eager))
    assert not torch.equal(pools_[0], init[0])


@pytest.mark.parametrize("dtype,hq,hkv,d", [
    (torch.float32, 4, 2, 14), (torch.bfloat16, 28, 4, 128)])
def test_graph_replay_flash_attention_bit_identical(gen, dtype, hq, hkv, d):
    q, k, v = (torch.randn((2, 100, h, d), generator=gen, device="cuda")
               .to(dtype).transpose(1, 2) for h in (hq, hkv, hkv))
    want = ops.flash_attention(q, k, v)
    graph, got = captured(lambda: ops.flash_attention(q, k, v))
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,hkv,g,d,page", [
    (torch.float32, 2, 2, 14, 4), (torch.bfloat16, 4, 7, 128, 16)])
def test_graph_replay_paged_attention_bit_identical(gen, quant, dtype, hkv,
                                                     g, d, page):
    """Paged decode and continuation attention, native and int8 pools,
    replayed from graphs: bit-identical to their eager launches."""
    b, frames, maxp = 4, 64, 12
    shape = (frames, page, hkv, d)
    if quant:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen,
                                device="cuda", dtype=torch.int32)
                  .to(torch.int8) for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(2))
    lens = [page * 5 + 3, 0, 1, page * maxp]
    table = mapped_table(gen, b, maxp, frames, [-(-n // page) for n in lens])
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kvs = 1 / 24 if quant else None
    q = torch.randn((b, hkv, g, d), generator=gen, device="cuda").to(dtype)
    starts = torch.tensor([page + 3, 2 * page, 0, 5], dtype=torch.int32,
                          device="cuda")
    qp = torch.randn((b, 37, hkv * g * d), generator=gen,
                     device="cuda").to(dtype).view(b, 37, hkv, g, d)
    for fn in (lambda: ops.paged_decode_attention(
                   q, kp, vp, table, sl, page_size=page, kv_scale=kvs),
               lambda: ops.paged_prefill_attention(
                   qp, kp, vp, table, starts, page_size=page,
                   kv_scale=kvs)):
        want = fn()
        graph, got = captured(fn)
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


#: the reduced engine's geometries: a pool that preempts (the mixed
#: workload of ``tests/test_serve_executor.py``), the default policy with
#: radix hits and partial restores, and forks of a 13-token prefix
REDUCED_COLD = dict(page_size=4, num_pages=16, max_pages_per_seq=16,
                    max_batch=3, prefix_cache=False, restore_patience=0)
REDUCED_WARM = dict(page_size=4, num_pages=16, max_pages_per_seq=16,
                    max_batch=3)
REDUCED_FORK = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
                    max_batch=4)


@pytest.fixture(scope="module")
def reduced():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-7b", reduced=True)
    model = build_model(cfg, device="cuda")
    return cfg, model, model.init(0)


def reduced_workload(cfg, kind):
    """``(prefix, requests)`` of a reduced engine case."""
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(13)
    v = cfg.vocab_size
    if kind == "fork":
        prefix = rng.integers(0, v, size=13).astype(np.int32)
        return prefix, [ServeRequest(
            req_id=i, max_new_tokens=6, share_prefix=True,
            prompt=rng.integers(0, v, size=n).astype(np.int32))
            for i, n in enumerate((1, 7, 12))]
    if kind == "radix":
        base = rng.integers(0, v, size=12).astype(np.int32)
        return None, [ServeRequest(req_id=i, max_new_tokens=12, prompt=np.
                                   concatenate([base[:8], rng.integers(
                                       0, v, size=int(rng.integers(4, 14)))
                                       .astype(np.int32)])) for i in range(7)]
    return None, [ServeRequest(req_id=i, max_new_tokens=12, prompt=rng.integers(
        0, v, size=int(rng.integers(4, 14))).astype(np.int32))
        for i in range(7)]


def serve_counted(model, params, scfg, prefix, reqs):
    """Serve with the launch counts zeroed before the engine is built;
    returns tokens, counters, switch stats, launches, routes, replays."""
    import dataclasses
    from repro_torch.serve import Engine
    ops.reset_launch_counts()
    eng = Engine(model, params, scfg)
    if prefix is not None:
        eng.preload_prefix(prefix)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    res = eng.drain()
    eng.close()
    return ({i: r.tokens for i, r in res.items()},
            dict(eng.counters.counters), eng.stats()["switch_stats"],
            ops.launch_counts(), ops.route_counts(), eng.executor.replays)


@pytest.mark.parametrize("case", [
    "cold", "int8", "radix", "fork", "buckets", "buckets_fork",
    "temperature", "temperature_horizon1"])
def test_engine_graphs_equal_eager(reduced, case):
    """The reduced engine with its programs replayed from CUDA graphs (the
    card's default) against the same engine inside ``disable_graphs()``:
    identical tokens, counters, switch stats, and kernel launches and
    routes (a replay adds what its capture recorded).  The temperature
    cases hold the graphs' sampling stream to the eager one."""
    from repro_torch.serve import ServeConfig, disable_graphs
    cfg, model, params = reduced
    kind = case.removeprefix("buckets_") if case.startswith("buckets") \
        else case
    kw = {"fork": REDUCED_FORK, "radix": REDUCED_WARM}.get(kind, REDUCED_COLD)
    extra = {"int8": dict(kv_dtype="int8"),
             "temperature": dict(greedy=False, temperature=0.8, seed=3),
             "temperature_horizon1": dict(greedy=False, temperature=0.8,
                                          seed=3, max_horizon=1),
             }.get(case, {})
    if case.startswith("buckets"):
        extra = dict(aot_buckets=(8, 16))
    scfg = ServeConfig(**kw, **extra)
    prefix, reqs = reduced_workload(cfg, "fork" if kind == "fork" else
                                    "radix" if kind == "radix" else "cold")
    graph = serve_counted(model, params, scfg, prefix, reqs)
    with disable_graphs():
        eager = serve_counted(model, params, scfg, prefix, reqs)
    assert graph[:5] == eager[:5]
    assert eager[5] == {}
    replays = graph[5]
    assert sum(n for (k, _), n in replays.items()
               if k.startswith("decode")) > 0
    if case.startswith("buckets"):
        kind_ = "continue" if kind == "fork" else "prefill"
        assert sum(n for (k, _), n in replays.items() if k == kind_) \
            == graph[1]["aot_hits"] > 0


def test_replay_adds_the_launches_its_capture_recorded(reduced):
    """Building the engine launches nothing the counters keep; each replay
    adds exactly what its capture recorded: one launch a layer of each
    kernel of the step, K a layer for a K-step horizon."""
    from repro_torch.serve import Engine, ServeConfig
    cfg, model, params = reduced
    ops.reset_launch_counts()
    eng = Engine(model, params, ServeConfig(**REDUCED_COLD, max_horizon=4,
                                            aot_buckets=(8,)))
    assert not any(ops.launch_counts().values())
    layers = cfg.num_layers
    want = {("decode", 1): {"paged_decode_attention": layers},
            ("decode_multi", 2): {"paged_decode_attention": 2 * layers},
            ("decode_multi", 4): {"paged_decode_attention": 4 * layers},
            ("prefill", 8): {"paged_copy": layers, "flash_attention": layers},
            ("continue", 8): {"paged_copy_at": layers,
                              "paged_prefill_attention": layers}}
    assert {k: g.launches for k, g in eng.executor._graphs.items()} == want
    for key, g in eng.executor._graphs.items():
        before = ops.launch_counts(), ops.route_counts()
        g.replay()                    # masked inputs: only scratch writes
        torch.cuda.synchronize()
        launches = {k: n - before[0][k] for k, n in ops.launch_counts().items()
                    if n != before[0][k]}
        routes = {k: {r: n - before[1][k][r] for r, n in per.items()
                      if n != before[1][k][r]}
                  for k, per in ops.route_counts().items()}
        assert launches == g.launches == want[key]
        assert {k: v for k, v in routes.items() if v} == g.routes
    eng.close()


def test_failed_capture_raises(reduced, monkeypatch):
    """A capture that fails raises out of the engine's build: it is never
    caught and never replaced by an eager run."""
    from repro_torch.serve import Engine, ServeConfig, disable_graphs
    cfg, model, params = reduced
    real = ops.paged_decode_attention

    def refuse_capture(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused during capture")
        return real(*args, **kw)

    monkeypatch.setattr(ops, "paged_decode_attention", refuse_capture)
    with pytest.raises(RuntimeError, match="refused during capture"):
        Engine(model, params, ServeConfig(**REDUCED_COLD))
    assert not torch.cuda.is_current_stream_capturing()
    with disable_graphs():            # the same steps run eagerly there
        Engine(model, params, ServeConfig(**REDUCED_COLD)).close()


def seed_served(model, params, scfg, prefix, reqs):
    """The frozen seed engine (``ReferenceEngine``) to the end, with the
    launch counts zeroed before it is built; returns tokens, counters,
    switch and pool stats, the FIFO's events and the launches."""
    from repro_torch.serve import ReferenceEngine, to_internal
    ops.reset_launch_counts()
    eng = ReferenceEngine(model, params, scfg)
    if prefix is not None:
        eng.preload_prefix(prefix)
    for r in reqs:
        eng.submit(to_internal(dataclasses.replace(r)))
    done = eng.run()
    st = eng.stats()
    return ({i: [int(t) for t in r.output] for i, r in done.items()},
            dict(eng.counters.counters), st["switch_stats"], st["pool"],
            [(e.event, e.payload) for e in eng.counters.events()],
            ops.launch_counts())


@pytest.mark.parametrize("case", ["cold", "int8", "fork"])
def test_seed_engine_card_equals_cpu(reduced, case):
    """The reduced seed engine on the card against the same engine and
    weights on the CPU: identical tokens, every counter, switch and pool
    stats and events; on the card ``paged_copy``, ``flash_attention`` and
    ``paged_decode_attention`` launch (forks teacher-forced through
    ``decode_step``: no continuation kernel)."""
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig
    cfg, model, params = reduced
    kv = "int8" if case == "int8" else "native"
    card = model if kv == "native" else build_model(cfg, device="cuda",
                                                    kv_dtype=kv)
    cpu = build_model(cfg, device="cpu", kv_dtype=kv)
    scfg = ServeConfig(**(REDUCED_FORK if case == "fork" else REDUCED_COLD))
    prefix, reqs = reduced_workload(cfg, "fork" if case == "fork" else "cold")
    got = seed_served(card, params, scfg, prefix, reqs)
    want = seed_served(cpu, on(params, "cpu"), scfg, prefix, reqs)
    assert got[:5] == want[:5]
    assert not any(want[5].values())
    launches = got[5]
    for k in ("paged_copy", "flash_attention", "paged_decode_attention"):
        assert launches[k] > 0, k
    assert launches["paged_copy_at"] == launches[
        "paged_prefill_attention"] == 0
    if case == "fork":
        assert got[1]["forked_admissions"] == 3
    else:
        assert got[1]["preemptions"] > 0 and got[2]["bytes_spilled"] > 0


# ---------------------------------------------------------------------------
# the multi-replica serve path: the router over engines on one card
# ---------------------------------------------------------------------------


def on(params, dev):
    """A params tree (dicts and lists of tensors) on ``dev``."""
    if isinstance(params, dict):
        return {k: on(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [on(v, dev) for v in params]
    return params.to(dev)


def routed(model, params, scfg, reqs, n, engines_cfg=None):
    """Serve ``reqs`` through a least-loaded router over ``n`` engines on
    one weight set; returns the router and its engines, drained."""
    import dataclasses
    from repro_torch.serve import Engine, ReplicaRouter
    engines = [Engine(model, params, (engines_cfg or {}).get(i, scfg))
               for i in range(n)]
    router = ReplicaRouter([e.as_replica(i) for i, e in enumerate(engines)])
    for r in reqs:
        router.submit(dataclasses.replace(r))
    router.drain()
    for e in engines:
        e.close()
    router.check_invariants()
    return router, engines


def router_record(router, engines):
    """Tokens, statuses, router counters, per-replica counters (less
    ``prefill_bytes_gathered``, which counts by the route that ran) and
    switch stats of a drained router."""
    reps = []
    for e in engines:
        c = dict(e.counters.counters)
        c.pop("prefill_bytes_gathered", None)
        reps.append((c, e.stats()["switch_stats"]))
    return ({i: (list(r.output), r.status) for i, r in router.done.items()},
            dict(router.counters.counters), reps,
            [s.payload for s in router.counters.events("migrate")])


@pytest.mark.parametrize("kind", ["cold", "radix"])
def test_router_n2_card_equals_cpu(reduced, kind):
    """Two reduced engines behind the router on the card (graphs replayed)
    equal the same router over the same weights on the CPU: greedy tokens,
    statuses, every router and per-replica counter, switch stats."""
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig
    cfg, model, params = reduced
    scfg = ServeConfig(**(REDUCED_WARM if kind == "radix" else REDUCED_COLD))
    _, reqs = reduced_workload(cfg, kind)
    card = routed(model, params, scfg, reqs, 2)
    cpu = routed(build_model(cfg, device="cpu"), on(params, "cpu"), scfg,
                 reqs, 2)
    assert router_record(*card) == router_record(*cpu)
    for e in card[1]:
        assert e.counters.get("decode_tokens") > 0
        assert sum(n for (k, _), n in e.executor.replays.items()
                   if k.startswith("decode")) > 0


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_router_rescue_restores_record_bytes_and_replays(reduced, kv_dtype):
    """A victim stranded on a small replica is rescued to a roomy one on the
    card: the destination's restored frames hold the record's bytes bit
    for bit, the request then decodes in graph replays, and its greedy
    tokens equal a lone roomy engine's."""
    import numpy as np
    from repro_torch.serve import Engine, ReplicaRouter, ServeConfig, \
        ServeRequest
    cfg, model, params = reduced
    big = ServeConfig(page_size=4, num_pages=64, max_pages_per_seq=32,
                      max_batch=3, max_horizon=1, kv_dtype=kv_dtype)
    small = ServeConfig(page_size=4, num_pages=8, max_pages_per_seq=8,
                        max_batch=3, max_horizon=1, kv_dtype=kv_dtype)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, size=24)
    sreq = ServeRequest(req_id=0, prompt=prompt.astype(np.int32),
                        max_new_tokens=8)
    lone = Engine(model, params, big)
    lone.submit(sreq)
    want = lone.drain()[0].tokens
    lone.close()
    e_small, e_big = Engine(model, params, small), Engine(model, params, big)
    router = ReplicaRouter([e_small.as_replica(0), e_big.as_replica(1)],
                           migrate_after=2)
    router.submit(sreq)
    s0, s1 = e_small.scheduler, e_big.scheduler
    while not (0 in s1.running and s1.vmem.config.pages_for(
            s1.vmem.seq_len(0)) > s0.attainable_pages()):
        router.step()
    s1.spill(s1.running[0])
    record = s1.export_swapped(0)
    s0.import_swapped(record)
    restored = {}
    real = e_big.switcher.restore_kv

    def restore_kv(seq_id, k_pools, v_pools, **kw):
        out = real(seq_id, k_pools, v_pools, **kw)
        frames = e_big.vmem.seq(seq_id).pages
        restored["k"] = k_pools[:, frames].cpu()
        restored["v"] = v_pools[:, frames].cpu()
        restored["replays"] = dict(e_big.executor.replays)
        return out

    e_big.switcher.restore_kv = restore_kv
    res = router.drain()
    assert router.counters.get("restore_migrations") == 1
    assert router.global_counters()["failed_unreachable"] == 0
    page_data = record.record.page_data
    assert torch.equal(restored["k"], page_data[0])
    assert torch.equal(restored["v"], page_data[1])
    after = e_big.executor.replays[("decode", 1)]
    assert after > restored["replays"][("decode", 1)]
    assert res[0].tokens == want
    assert e_small.switcher.swapped_out == e_big.switcher.swapped_out == []
    router.check_invariants()


def test_engines_on_one_weight_set_hold_it_once(reduced):
    """N engines built over one model and one params tree hold the weights
    once: the card's allocated bytes grow by each engine's pools, page
    table, buffers and graphs, and by no copy of the weights."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg, _, _ = reduced
    wide = dataclasses.replace(cfg, vocab_size=65536)   # weights dominate
    model = build_model(wide, device="cuda")
    params = model.init(0)
    weights = sum(t.numel() * t.element_size()
                  for t in torch.utils._pytree.tree_leaves(params))
    # a first build allocates what the process keeps once (the cuBLAS
    # workspace of the captures' shared warm-up stream): not an engine's
    Engine(model, params, ServeConfig(**REDUCED_COLD)).close()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    engines = [Engine(model, params, ServeConfig(**REDUCED_COLD))]
    one = torch.cuda.memory_allocated() - base
    engines += [Engine(model, params, ServeConfig(**REDUCED_COLD))
                for _ in range(3)]
    four = torch.cuda.memory_allocated() - base
    assert one < weights / 4, (one, weights)
    assert four < 4 * one + weights / 4, (four, one, weights)
    assert all(e.executor.params is params for e in engines)
    for e in engines:
        e.close()


def test_capture_survives_garbage_collection(reduced, monkeypatch):
    """An engine that served and was dropped in a reference cycle is
    cyclic garbage; if the collector freed it (its graphs, its buffers)
    while another executor captured, the capture would be invalidated.
    Here the garbage is still young (no collection since it was made) and
    loses its last reference inside the capture, where the collector is
    then at its most eager; the new engine still builds and serves, and
    the garbage goes after the capture."""
    import gc
    import numpy as np
    from repro_torch.serve import Engine, ServeConfig, ServeRequest
    cfg, model, params = reduced
    real = type(model).decode_multi_step
    hold = []

    def drop_during_capture(*args, **kw):
        if hold and torch.cuda.is_current_stream_capturing():
            hold.clear()
            gc.set_threshold(1)
            junk = [[object()] for _ in range(1000)]     # trips gen 0
            del junk
        return real(*args, **kw)

    thresholds = gc.get_threshold()
    gc.collect()
    gc.set_threshold(10**9)            # nothing ages into an older gen
    try:
        old = Engine(model, params, ServeConfig(**REDUCED_COLD))
        old.submit(ServeRequest(prompt=np.arange(5, dtype=np.int32) + 1,
                                max_new_tokens=4))
        assert old.drain()[0].status == "done"
        old.executor.cycle = old
        hold.append(old)
        del old
        monkeypatch.setattr(type(model), "decode_multi_step",
                            drop_during_capture)
        eng = Engine(model, params, ServeConfig(**REDUCED_COLD))
    finally:
        gc.set_threshold(*thresholds)
    assert not hold and gc.isenabled()
    eng.submit(ServeRequest(prompt=np.arange(5, dtype=np.int32) + 1,
                            max_new_tokens=4))
    assert eng.drain()[0].status == "done"
    eng.close()
    gc.collect()


# ---------------------------------------------------------------------------
# ragged_dot (the MoE path's grouped expert product) and the MoE engines
# ---------------------------------------------------------------------------


def ragged_sizes(gen, m, e, spec):
    """int32 group sizes on the card: ``spec`` as given, or ``m`` rows of
    random experts (top-8 routing of ``m / 8`` tokens: empty experts are
    likely at decode sizes)."""
    if spec != "random":
        return torch.tensor(spec, dtype=torch.int32, device="cuda")
    ids = torch.randint(0, e, (m,), generator=gen, device="cuda")
    return torch.bincount(ids, minlength=e).int()


def ragged_within(got, want, dtype):
    """Each row within 1e-5 (f32) or four bf16 steps of its largest
    output."""
    diff = (got.float() - want.float()).abs().amax(-1)
    peak = want.float().abs().amax(-1)
    step = 1e-5 if dtype == torch.float32 else 4 * 2**-8
    assert bool((diff <= step * peak + 1e-6).all()), float(diff.max())


#: the route rule's threshold over 32 experts (K 256, N 128)
RAGGED_EDGE = 32 * 32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,e,spec,bf16", [
    (32, 1024, 512, 32, "random", "mma"),           # granite decode, 4 lanes
    (32, 512, 1024, 32, "random", "mma"),           # its down projection
    (16384, 1024, 512, 32, "random", "wgmma"),      # a 2,048-token prefill
    (300, 512, 1024, 32, [0] * 31 + [300], "mma"),  # one expert, every row
    (70, 64, 72, 4, [10, 0, 50, 0], "mma"),         # empty groups, 10 past
    (5, 16, 8, 8, [0, 1, 0, 1, 1, 0, 2, 0], "mma"),
    # groups ending inside a 128-row tile, 50 rows past the last group
    (600, 64, 136, 4, [100, 300, 0, 150], "wgmma"),
    (1000, 256, 256, 8, "random", "wgmma"),         # M not a multiple of 128
    (32, 1024, 512, 32, [0] * 7 + [32] + [0] * 24, "mma"),  # one touched
    (RAGGED_EDGE - 1, 256, 128, 32, "random", "mma"),    # the route rule's
    (RAGGED_EDGE, 256, 128, 32, "random", "wgmma"),      # threshold and one
    (RAGGED_EDGE + 1, 256, 128, 32, "random", "wgmma"),  # row either side
])
def test_ragged_dot_against_plain_version(gen, dtype, m, k, n, e, spec,
                                          bf16):
    """Each case on the route it names: bf16 ``"mma"`` below 32 rows per
    expert and ``"wgmma"`` from it, f32 ``"simt"``."""
    from repro_torch.kernels.ragged_dot import ROUTES, ragged_route
    route = bf16 if dtype == torch.bfloat16 else "simt"
    xs = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = torch.randn((e, k, n), generator=gen, device="cuda").div(
        k ** 0.5).to(dtype)
    gs = ragged_sizes(gen, m, e, spec)
    assert ragged_route(xs, w) == route
    ops.reset_launch_counts()
    got = ops.ragged_dot(xs, w, gs)
    assert ops.route_counts()["ragged_dot"] == {**dict.fromkeys(ROUTES, 0),
                                                route: 1}
    want = ref.ragged_dot_ref(xs, w, gs)
    torch.cuda.synchronize()
    ragged_within(got, want, dtype)
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("dtype,m,e,route", [
    (torch.bfloat16, 32, 32, "mma"), (torch.bfloat16, 2048, 32, "wgmma"),
    (torch.bfloat16, 600, 4, "wgmma"), (torch.float32, 300, 8, "simt")])
def test_ragged_dot_two_launches_bit_identical(gen, dtype, m, e, route):
    """No route splits K or adds with atomics: two launches on the same
    operands agree bit for bit (a graph run and its eager twin must pick
    the same greedy tokens)."""
    from repro_torch.kernels.ragged_dot import ragged_route
    k, n = 512, 256
    xs = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = torch.randn((e, k, n), generator=gen, device="cuda").to(dtype)
    gs = ragged_sizes(gen, m, e, "random")
    assert ragged_route(xs, w) == route
    first = ops.ragged_dot(xs, w, gs)
    second = ops.ragged_dot(xs, w, gs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_ragged_dot_bf16_off_the_tensor_cores_raises(gen):
    """A bf16 view whose base is off 16 bytes, or an N not a multiple of 8,
    is refused before any launch: bf16 runs on the tensor cores only."""
    xs = torch.randn((40, 65), generator=gen, device="cuda").bfloat16()
    w = torch.randn((3, 64, 24), generator=gen, device="cuda").bfloat16()
    gs = torch.tensor([7, 0, 30], dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    for x_, w_ in ((xs[:, 1:], w), (xs[:, :64], w[:, :, :20])):
        with pytest.raises(ValueError, match="tensor cores only"):
            ops.ragged_dot(x_, w_, gs)
    assert ops.launch_counts()["ragged_dot"] == 0


@pytest.mark.parametrize("m,sizes,route", [
    (150, [48, 1, 0, 52, 40], "mma"),          # 30 rows per expert
    (700, [130, 1, 0, 300, 250], "wgmma")])    # 140
def test_ragged_dot_exact_layout_probe(gen, m, sizes, route):
    """Integer-valued bf16 operands small enough that every sum is exact:
    a wrong fragment map, ldmatrix or swizzle address, wgmma descriptor or
    group offset shows as a mismatch, not as rounding; on each tensor-core
    route, with rows past the last group."""
    from repro_torch.kernels.ragged_dot import ragged_route
    k, n, e = 64, 128, 5
    xs = torch.randint(-3, 4, (m, k), generator=gen, device="cuda").bfloat16()
    w = torch.randint(-3, 4, (e, k, n), generator=gen,
                      device="cuda").bfloat16()
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    assert ragged_route(xs, w) == route
    got = ops.ragged_dot(xs, w, gs)
    assert torch.equal(got, ref.ragged_dot_ref(xs, w, gs))


@pytest.mark.parametrize("dtype,m,route", [(torch.bfloat16, 96, "mma"),
                                           (torch.float32, 96, "simt"),
                                           (torch.bfloat16, 384, "wgmma")])
def test_graph_replay_ragged_dot_with_new_group_sizes(gen, dtype, m, route):
    """One capture, replayed after the group sizes and rows change in
    place on the card: the kernel reads the sizes from device memory, so
    the replay computes the new grouping; on every route."""
    from repro_torch.kernels.ragged_dot import ragged_route
    k, n, e = 128, 64, 6
    xs = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = torch.randn((e, k, n), generator=gen, device="cuda").to(dtype)
    assert ragged_route(xs, w) == route
    gs = torch.tensor([m, 0, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    graph, got = captured(lambda: ops.ragged_dot(xs, w, gs))
    q = m // 96
    for sizes in ([0, 40 * q, 0, 56 * q, 0, 0],
                  [10 * q, 10 * q, 10 * q, 10 * q, 10 * q, 46 * q],
                  [0, 0, 0, 0, 0, 90 * q]):
        gs.copy_(torch.tensor(sizes, dtype=torch.int32))
        xs.copy_(torch.randn((m, k), generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        ragged_within(got, ref.ragged_dot_ref(xs, w, gs), dtype)
        assert not got[sum(sizes):].any()


MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", ["cold", "int8", "radix", "buckets"])
def test_moe_engine_graphs_equal_eager_and_cpu(arch, case):
    """The reduced MoE engine (f32) on the card with graphs, inside
    ``disable_graphs()`` and on the CPU: identical greedy tokens and
    counters (less ``prefill_bytes_gathered``, which counts by route);
    graph and eager identical in launches and routes, ``ragged_dot`` on
    its CUDA-core route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, disable_graphs
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=True)
    cpu = build_model(cfg, device="cpu")
    cpu_params = cpu.init(0)
    card = build_model(cfg, device="cuda")
    params = on(cpu_params, "cuda")
    kw = REDUCED_WARM if case == "radix" else REDUCED_COLD
    extra = {"int8": dict(kv_dtype="int8"),
             "buckets": dict(aot_buckets=(8, 16))}.get(case, {})
    scfg = ServeConfig(**kw, **extra)
    prefix, reqs = reduced_workload(cfg, "radix" if case == "radix"
                                    else "cold")
    graph = serve_counted(card, params, scfg, prefix, reqs)
    with disable_graphs():
        eager = serve_counted(card, params, scfg, prefix, reqs)
    plain = serve_counted(cpu, cpu_params, scfg, prefix, reqs)
    assert graph[:5] == eager[:5]
    for c in (graph[1], plain[1]):
        c.pop("prefill_bytes_gathered", None)
    assert graph[:3] == plain[:3]
    assert graph[3]["ragged_dot"] > 0
    assert graph[4]["ragged_dot"] == {"mma": 0, "wgmma": 0,
                                      "simt": graph[3]["ragged_dot"]}


@pytest.mark.parametrize("dispatch", ["ragged", "sorted_rows"])
def test_graph_capture_of_moe_dispatches(gen, dispatch):
    """Each MoE dispatch of the serve path captures as a CUDA graph (a
    host sync inside would make the capture raise) and its replay on new
    inputs equals an eager call: routing, sort, group sizes, capacity
    drops and combine all read device memory only."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    params = M.moe_init(gen, cfg, torch.bfloat16)
    x = torch.randn((3, 40, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    kw = dict(num_experts=cfg.num_experts, k=cfg.experts_per_token)

    def call():
        if dispatch == "ragged":
            return M.moe_apply_ragged(params, x.view(-1, cfg.d_model),
                                      **kw)[0]
        return M.moe_apply_sorted_rows(params, x, capacity_factor=0.5,
                                       **kw)[0]
    graph, got = captured(call)
    for _ in range(2):
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        graph.replay()
        want = call()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the VLM and audio families: musicgen's G 1 shapes, the reduced engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_attention_mma_musicgen_shape(gen, quant):
    """musicgen-large's decode shape (Hkv 32, G 1: one query row of the
    m16 tile live, D 64, page 16) at the serve batch: lengths past a
    page, an empty lane, a 1-token lane and a long one that splits; each
    output row within four bf16 steps of its largest value, on the
    tensor-core route, bf16 and int8 pools."""
    b, hkv, g, d, page, maxp = 4, 32, 1, 64, 16, 36
    frames = b * maxp
    lens = [page * 9 + 5, 0, 1, page * maxp - 3]
    q = torch.randn((b, hkv, g, d), generator=gen, device="cuda").bfloat16()
    kp, vp = pools(gen, frames, page, hkv, d, quant)
    table = mapped_table(gen, b, maxp, frames, [-(-n // page) for n in lens])
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kvs = 1 / 24 if quant else None
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, kp, vp, table, sl, page_size=page,
                                     kv_scale=kvs)
    assert ops.route_counts()["paged_decode_attention"] == {
        "mma": 1, "simt": 0}
    want = ref.paged_decode_attention_ref(q, kp, vp, table, sl,
                                          page_size=page, kv_scale=kvs)
    torch.cuda.synchronize()
    rows_within(got, want)
    assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("quant", [False, True])
def test_paged_prefill_attention_wgmma_musicgen_shape(gen, quant):
    """musicgen-large's continuation shape (Hkv 32, G 1, D 64, page 16:
    128 query tokens a block): a radix hit's chunk of 321 tokens after 128
    cached ones, a mid-page start with a 17-token chunk and a zero start;
    q the strided view of the projection; each real row within four bf16
    steps of its largest value, on the tensor-core route, bf16 and int8
    pools."""
    from repro_torch.kernels.paged_prefill_attention import query_block
    b, hkv, g, d, page, maxp = 3, 32, 1, 64, 16, 36
    frames = b * maxp
    s = 336
    starts_l, chunks = [128, 261, 0], [321, 17, 200]
    assert query_block(g, "wgmma") == 128
    q = torch.randn((b, s, hkv * g * d), generator=gen,
                    device="cuda").bfloat16().view(b, s, hkv, g, d)
    kp, vp = pools(gen, frames, page, hkv, d, quant)
    table = mapped_table(gen, b, maxp, frames, [
        min(-(-(st + c) // page), maxp) for st, c in zip(starts_l, chunks)])
    starts = torch.tensor(starts_l, dtype=torch.int32, device="cuda")
    kvs = 1 / 24 if quant else None
    ops.reset_launch_counts()
    got = ops.paged_prefill_attention(q, kp, vp, table, starts,
                                      page_size=page, kv_scale=kvs)
    assert ops.route_counts()["paged_prefill_attention"] == {
        "wgmma": 1, "simt": 0}
    want = ref.paged_prefill_attention_ref(q, kp, vp, table, starts,
                                           page_size=page, kv_scale=kvs)
    torch.cuda.synchronize()
    for i, c in enumerate(chunks):
        rows_within(got[i, :c], want[i, :c])


def family_workload(cfg, tok, kind):
    """The reduced cold or shared-base workload with prompts of ``tok``
    trailing shape (``(K,)``: audio frames of K codebook tokens)."""
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(13)
    v = cfg.vocab_size
    if kind == "radix":
        base = rng.integers(0, v, size=(12,) + tok).astype(np.int32)
        return [ServeRequest(req_id=i, max_new_tokens=12, prompt=np.
                             concatenate([base[:8], rng.integers(
                                 0, v, size=(int(rng.integers(4, 14)),)
                                 + tok).astype(np.int32)]))
                for i in range(7)]
    return [ServeRequest(req_id=i, max_new_tokens=12, prompt=rng.integers(
        0, v, size=(int(rng.integers(4, 14)),) + tok).astype(np.int32))
        for i in range(7)]


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "musicgen-large"])
@pytest.mark.parametrize("case", ["cold", "int8", "radix"])
def test_family_engine_graphs_equal_eager_and_cpu(arch, case):
    """The reduced VLM (M-RoPE) and audio (``[B, 4]`` tokens through the
    step programs' buffers, the captured horizons' ``[K, B, 4]`` blocks)
    engines, f32, on the card with graphs, inside ``disable_graphs()`` and
    on the CPU: identical greedy tokens, counters (less
    ``prefill_bytes_gathered``, which counts by route) and switch stats;
    graph and eager identical in launches and routes, decode replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, disable_graphs
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=True)
    cpu = build_model(cfg, device="cpu")
    cpu_params = cpu.init(0)
    card = build_model(cfg, device="cuda")
    params = on(cpu_params, "cuda")
    kw = REDUCED_WARM if case == "radix" else REDUCED_COLD
    extra = {"int8": dict(kv_dtype="int8")}.get(case, {})
    scfg = ServeConfig(**kw, **extra)
    reqs = family_workload(cfg, card.token_shape, case)

    def tokens(run):
        return {i: np.asarray(t).tolist() for i, t in run[0].items()}
    graph = serve_counted(card, params, scfg, None, reqs)
    with disable_graphs():
        eager = serve_counted(card, params, scfg, None, reqs)
    plain = serve_counted(cpu, cpu_params, scfg, None, reqs)
    assert tokens(graph) == tokens(eager) == tokens(plain)
    assert graph[1:5] == eager[1:5]
    for c in (graph[1], plain[1]):
        c.pop("prefill_bytes_gathered", None)
    assert graph[1:3] == plain[1:3]
    assert all(np.shape(t) == (12,) + card.token_shape
               for t in graph[0].values())
    assert eager[5] == {}
    assert sum(n for (k, _), n in graph[5].items()
               if k.startswith("decode")) > 0
    for n in ("paged_prefill_attention",) if case == "radix" else (
            "paged_copy", "flash_attention", "paged_decode_attention"):
        assert graph[3][n] > 0


# ---------------------------------------------------------------------------
# the RG-LRU family: decode attention at D 256 with its window, the scan
# ---------------------------------------------------------------------------


def d256_case(gen, b, dtype, quant, page=16):
    """recurrentgemma-9b's decode operands (one KV head, G 16, D 256):
    ``b`` rows of the lengths 2,576, 543, 16 and 1 in turn, distinct
    shuffled frames, and one entry of the longest row unmapped (-1) inside
    the window (it reads frame 0, as the plain version does)."""
    lens = [(2576, 543, 16, 1)[i % 4] for i in range(b)]
    maxp = -(-max(lens) // page)
    frames = b * maxp
    q = torch.randn((b, 1, 16, 256), generator=gen, device="cuda").to(dtype)
    if quant:
        kp, vp = pools(gen, frames, page, 1, 256, True)
    else:
        kp, vp = (torch.randn((frames, page, 1, 256), generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
    table = mapped_table(gen, b, maxp, frames, [-(-n // page) for n in lens])
    long_row = lens.index(max(lens))
    table[long_row, maxp - 20] = -1
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, sl


@pytest.mark.parametrize("window", [None, 2048, 100])
@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("route,dtype,quant", [
    ("mma", torch.bfloat16, False), ("mma", torch.bfloat16, True),
    ("simt", torch.float32, False)])
def test_paged_decode_attention_d256(gen, route, dtype, quant, b, window):
    """D 256 at G 16 on both routes, bf16 (and int8) pools on ``"mma"``,
    f32 on ``"simt"``, with recurrentgemma-9b's window of 2,048, a window
    of 100 and none; f32 within 1e-5, bf16 each row within four bf16 steps
    of its largest value."""
    q, kp, vp, table, sl = d256_case(gen, b, dtype, quant)
    kvs = 1 / 24 if quant else None
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, kp, vp, table, sl, page_size=16,
                                     window=window, kv_scale=kvs)
    assert ops.route_counts()["paged_decode_attention"] == {
        "mma": int(route == "mma"), "simt": int(route == "simt")}
    want = ref.paged_decode_attention_ref(q, kp, vp, table, sl, page_size=16,
                                          window=window, kv_scale=kvs)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        rows_within(got, want)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_attention_d256_exact_layout_probe(gen, quant):
    """As the D 128 probe, at D 256 (Q's fragments read from shared
    memory): every query head picks one visible key by one-hot pairs of
    width 256, so the output is that key's value row exactly; rows long
    enough that keys on pages past 64 (table entries read per slice) are
    picked, and a window."""
    b, page, maxp, g = 3, 16, 80, 16
    frames = b * maxp
    lens = torch.tensor([1270, 300, 17], dtype=torch.int32, device="cuda")
    perm = torch.randperm(frames, generator=gen, device="cuda").int()
    table = perm.view(b, maxp).contiguous()
    pos = torch.arange(maxp * page, device="cuda")

    def one_hot(p, big):
        x = torch.zeros((p.numel(), 256), device="cuda")
        idx = torch.arange(p.numel(), device="cuda")
        x[idx, p % 128] = big
        x[idx, 128 + p // 128] = big
        return x

    kp = torch.zeros((frames, page, 1, 256), device="cuda")
    for i in range(b):
        kp[table[i].long()[pos // page], pos % page, 0] = one_hot(pos, 1.0)
    vp = torch.randint(-100, 101, (frames, page, 1, 256), generator=gen,
                       device="cuda").float()
    kvs = 1 / 24 if quant else None
    kp, vp = ((kp * 24).to(torch.int8), vp.to(torch.int8)) if quant else (
        kp.bfloat16(), vp.bfloat16())
    for window in (None, 600):
        lo = (lens.long() - window).clamp(min=0) if window else 0 * lens.long()
        span = lens.long() - lo
        j = torch.randint(0, 1 << 30, (b, 1, g), generator=gen,
                          device="cuda") % span[:, None, None]
        j = j + lo[:, None, None]
        j[0, 0, 0] = lens[0] - 1                   # page 79: read per slice
        q = one_hot(j.flatten(), 128.0).view(b, 1, g, 256).bfloat16()
        ops.reset_launch_counts()
        got = ops.paged_decode_attention(q, kp, vp, table, lens,
                                         page_size=page, scale=1.0,
                                         window=window, kv_scale=kvs)
        assert ops.route_counts()["paged_decode_attention"]["mma"] == 1
        fr = table.long()[torch.arange(b, device="cuda")[:, None, None],
                          j // page]
        v = vp[fr, j % page, 0]
        v = (v.float() * kvs).bfloat16() if quant else v
        assert torch.equal(got, v)


def test_graph_replay_paged_attention_d256_bit_identical(gen):
    """The D 256 launch with the window, replayed from a graph: bit-identical
    to its eager launch."""
    q, kp, vp, table, sl = d256_case(gen, 8, torch.bfloat16, False)

    def call():
        return ops.paged_decode_attention(q, kp, vp, table, sl,
                                          page_size=16, window=2048)
    want = call()
    graph, got = captured(call)
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def rglru_case(gen, b, t, r, dtype, with_h0=True):
    """One recurrent layer's RG-LRU operands as the model makes them: conv
    and the gate weights in ``dtype`` (weights normal / sqrt(R), as
    ``dense_init``), ``lam`` uniform in [0.4, 0.8), ``h0`` normal or
    zero."""
    conv = torch.randn((b, t, r), generator=gen, device="cuda").to(dtype)
    w_r, w_i = ((torch.randn((r, r), generator=gen, device="cuda")
                 / r ** 0.5).to(dtype) for _ in range(2))
    lam = 0.4 + 0.4 * torch.rand((r,), generator=gen, device="cuda")
    h0 = (torch.randn((b, r), generator=gen, device="cuda") if with_h0
          else torch.zeros((b, r), device="cuda"))
    return conv, w_r, w_i, lam, h0


@pytest.mark.parametrize("b,r", [(8, 4096), (1, 4096), (16, 4096),
                                 (3, 300)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_step_against_plain_version(gen, b, r, with_h0):
    """The step route (one launch: both gate GEMVs from the bf16 weights,
    the gate math and the step) at recurrentgemma-9b's decode rows (8),
    the window run's (1), the most it stages (16) and a width that is no
    multiple of the 16-byte loads or the block's 32 channels (300, rows 3
    padded to 4): each row of h within ``rglru.STEP_TOL`` of its peak, and
    two launches bit-identical (split K reduced in a fixed order)."""
    args = rglru_case(gen, b, 1, r, torch.bfloat16, with_h0)
    ops.reset_launch_counts()
    got = ops.rglru(*args)
    again = ops.rglru(*args)
    assert ops.route_counts()["rglru"] == {"step": 2, "scan": 0}
    assert ops.launch_counts()["rglru"] == 2
    want = ref.rglru_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (b, 1, r) and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    rows_within(got, want, STEP_TOL, lead=True)


@pytest.mark.parametrize("b,t,r,dtype", [
    (8, 512, 4096, torch.bfloat16), (8, 512, 4096, torch.float32),
    (8, 1, 4096, torch.float32), (17, 1, 512, torch.bfloat16),
    (1, 7, 100, torch.bfloat16), (1, 7, 100, torch.float32),
    (3, 513, 300, torch.bfloat16), (3, 513, 300, torch.float32),
    (2, 9, 128, torch.bfloat16), (2, 9, 128, torch.float32),
    (2, 64, 128, torch.bfloat16), (1, 2560, 4096, torch.bfloat16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_kernel_bit_identical(gen, b, t, r, dtype, with_h0):
    """The scan route against its plain version, bit-identical: the same
    torch.matmul products, then the gate math in PyTorch's CUDA order
    (sigmoid, softplus, exp, sqrt, each product and sum rounded alone)
    and one rounded product and sum a step.  At recurrentgemma-9b's
    512-token prefill and the window run's 2,560-token one, f32 weights
    at T = 1 (the reduced configs), 17 bf16 rows at T = 1 (one past the
    step route), widths that are no multiple of the block's 32 channels,
    T inside, at and one past the kernel's 32-step chunks."""
    args = rglru_case(gen, b, t, r, dtype, with_h0)
    ops.reset_launch_counts()
    got = ops.rglru(*args)
    assert ops.route_counts()["rglru"] == {"step": 0, "scan": 1}
    assert ops.launch_counts()["rglru"] == 1
    want = ref.rglru_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("t,route", [(1, "step"), (512, "scan")])
def test_graph_replay_rglru_scan_bit_identical(gen, t, route):
    """Each route replayed from a CUDA graph: bit-identical to its eager
    launch."""
    args = rglru_case(gen, 8, t, 4096, torch.bfloat16)
    ops.reset_launch_counts()
    want = ops.rglru(*args)
    assert ops.route_counts()["rglru"][route] == 1
    graph, got = captured(lambda: ops.rglru(*args))
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_reduced_rglru_card_equals_cpu(gen):
    """The reduced recurrentgemma-9b (f32: the RG-LRU on its scan route,
    the burst copy, decode attention on ``"simt"`` at D 16 with the window
    of 16) on
    the card against the CPU: a 20-token prefill and 12 greedy steps past
    the window, identical tokens, logits within 1e-4, exact launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("recurrentgemma-9b", reduced=True)
    cpu = build_model(cfg, device="cpu")
    cpu_params = cpu.init(0)
    card = build_model(cfg, device="cuda")
    params = on(cpu_params, "cuda")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 20)).astype(
        np.int32))
    lens = torch.full((3,), 20, dtype=torch.int32)
    table = torch.arange(3 * 10, dtype=torch.int32).view(3, 10)
    runs = []
    for model, p, dev in ((card, params, "cuda"), (cpu, cpu_params, "cpu")):
        st = model.init_state(3, 31, 4, 10)._replace(page_table=table.to(dev))
        ops.reset_launch_counts()
        logits, st = model.prefill(p, toks.to(dev), lens.to(dev), st)
        out, all_logits = [], [logits.cpu()]
        for _ in range(12):
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok.cpu())
            logits, st = model.decode_step(p, tok, st)
            all_logits.append(logits.cpu())
        runs.append((torch.stack(out), all_logits, ops.launch_counts(),
                     ops.route_counts()))
    (tg, lg, n, routes), (tc, lc, _, _) = runs
    assert torch.equal(tg, tc)
    for a, b_ in zip(lg, lc):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-4)
    assert n["rglru"] == 52 and routes["rglru"] == {"step": 0, "scan": 52}
    assert n["paged_copy"] == 1 and n["paged_decode_attention"] == 12
    assert routes["paged_decode_attention"] == {"mma": 0, "simt": 12}


# ---------------------------------------------------------------------------
# training: the losses and gradients on the card against the CPU
# ---------------------------------------------------------------------------


TRAIN_ARCHS = ["qwen2-7b", "granite-moe-1b-a400m",
               "llama4-maverick-400b-a17b", "qwen2-vl-7b", "musicgen-large",
               "rwkv6-7b", "recurrentgemma-9b"]


def _train_batch(cfg, b=2, s=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    audio = cfg.family == "audio" and cfg.num_codebooks > 1
    shape = (b, s + 1, cfg.num_codebooks) if audio else (b, s + 1)
    tok = torch.randint(0, cfg.vocab_size, shape, generator=g)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
           "mask": (torch.rand((b, s), generator=g) > 0.2).float()}
    if cfg.family == "vlm":
        pos = torch.arange(s).expand(b, s)
        out["positions"] = torch.stack([pos, pos // 2, pos % 5])
        out["vision_embeds"] = torch.randn((b, 4, cfg.d_model),
                                           generator=g) * 0.02
    return out


def _loss_grads(model, params, batch):
    from repro_torch.optim import tree_leaves
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss, _ = model.loss(params, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_reduced_card_equals_cpu(gen, arch):
    """One reduced config of each family (f32, TF32 off,
    ``use_kernels=False``): the loss within 1e-5, every gradient leaf
    within ``1e-4 * max|g| + 1e-7``, no kernel launched; one AdamW step on
    the card within 1e-6 of each leaf's peak of the CPU's step on the
    same gradients."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   tree_leaves, tree_unflatten)
    cfg = get_config(arch, reduced=True)
    cpu = build_model(cfg, device="cpu", use_kernels=False)
    card = build_model(cfg, device="cuda", use_kernels=False)
    cpu_params = cpu.init(0)
    params = on(cpu_params, "cuda")
    batch = _train_batch(cfg)
    ops.reset_launch_counts()
    loss, grads = _loss_grads(card, params, on(batch, "cuda"))
    want_loss, want = _loss_grads(cpu, cpu_params, batch)
    assert not any(ops.launch_counts().values())
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for a, b in zip(grads, want):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item() + 1e-7
    ocfg = AdamWConfig(base_lr=1e-3, warmup_steps=2, total_steps=8)
    with torch.no_grad():
        got, _, _ = adamw_update(tree_unflatten(params, grads),
                                 adamw_init(params), params, ocfg)
        ref_step, _, _ = adamw_update(
            tree_unflatten(cpu_params, [g.cpu() for g in grads]),
            adamw_init(cpu_params), cpu_params, ocfg)
    for a, b in zip(tree_leaves(got), tree_leaves(ref_step)):
        assert (a.cpu() - b).abs().max().item() <= 1e-6 * b.abs().max().item()


@pytest.mark.parametrize("arch,dtype,route", [
    ("qwen2-7b", torch.float32, "simt"),            # D 14
    ("granite-moe-1b-a400m", torch.float32, "simt"),
    ("granite-moe-1b-a400m", torch.bfloat16, "wgmma"),   # D 16
])
def test_train_no_grad_loss_with_kernels(gen, arch, dtype, route):
    """A ``use_kernels=True`` loss under ``torch.no_grad()`` launches one
    ``flash_attention`` a layer, on the named route, and nothing else, and
    equals the plain path's loss (1e-5 in f32, 1e-2 in bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch, reduced=True)
    if dtype == torch.bfloat16:       # the router stays f32, as in JAX
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    kmodel = build_model(cfg, device="cuda")
    plain = build_model(cfg, device="cuda", use_kernels=False)
    params = kmodel.init(0)
    batch = on(_train_batch(cfg), "cuda")
    with torch.no_grad():
        want = plain.loss(params, batch)[0].item()
        ops.reset_launch_counts()
        got = kmodel.loss(params, batch)[0].item()
    n = ops.launch_counts()
    assert n["flash_attention"] == cfg.num_layers
    assert sum(n.values()) == cfg.num_layers
    assert ops.route_counts()["flash_attention"][route] == cfg.num_layers
    assert got == pytest.approx(want, rel=1e-5 if dtype == torch.float32
                                else 1e-2)


@pytest.mark.parametrize("name", ["flash_attention", "ragged_dot", "rglru",
                                  "wkv6"])
def test_kernel_refuses_grad_on_card(gen, name):
    """A CUDA input that requires grad never reaches a hand-written kernel
    under grad mode: the wrapper raises before any launch; under
    ``torch.no_grad()`` the same call launches once."""
    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    calls = {
        "flash_attention": lambda x: ops.flash_attention(
            x, rnd(1, 2, 6, 16), rnd(1, 2, 6, 16)),
        "ragged_dot": lambda x: ops.ragged_dot(
            x, rnd(3, 16, 8), torch.tensor([2, 0, 3], dtype=torch.int32,
                                           device="cuda")),
        "rglru": lambda x: ops.rglru(x, rnd(16, 16), rnd(16, 16), rnd(16),
                                     torch.zeros(2, 16, device="cuda")),
        "wkv6": lambda x: ops.wkv6(x, rnd(2, 3, 8), rnd(2, 3, 8),
                                   torch.rand(2, 3, 8, generator=gen,
                                              device="cuda"), rnd(2, 8)),
    }
    first = {"flash_attention": (1, 4, 6, 16), "ragged_dot": (5, 16),
             "rglru": (2, 3, 16), "wkv6": (2, 3, 8)}[name]
    x = rnd(*first).requires_grad_(True)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"^{name}: "):
        calls[name](x)
    assert not any(ops.launch_counts().values())
    with torch.no_grad():
        calls[name](x)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == 1


# ---------------------------------------------------------------------------
# the training loop: make_train_step, remat, the checkpointer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", [a for a in TRAIN_ARCHS
                                  if a != "qwen2-vl-7b"])
def test_train_step_card_equals_cpu(gen, arch, accum):
    """``make_train_step`` (single, and two microbatches) on the card and
    on the CPU from the same weights and batch: the loss within 1e-5
    relative, the card's parameters within 1e-6 of each leaf's peak of
    the CPU optimizer's step on the gradients the card's step handed to
    its update; no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   tree_leaves, tree_map)
    from repro_torch.train import loop, make_train_step
    cfg = get_config(arch, reduced=True)
    ocfg = AdamWConfig(base_lr=1e-3, warmup_steps=2, total_steps=8)
    cpu = build_model(cfg, device="cpu", use_kernels=False)
    card = build_model(cfg, device="cuda", use_kernels=False)
    cpu_params = cpu.init(0)
    params = on(cpu_params, "cuda")
    batch = _train_batch(cfg)
    seen, real = [], loop.adamw_update

    def spy(grads, *a, **kw):
        seen.append(grads)
        return real(grads, *a, **kw)
    ops.reset_launch_counts()
    try:
        loop.adamw_update = spy
        got, _, met = make_train_step(card, ocfg, accum_steps=accum)(
            params, adamw_init(params), on(batch, "cuda"))
        _, _, want_met = make_train_step(cpu, ocfg, accum_steps=accum)(
            cpu_params, adamw_init(cpu_params), batch)
    finally:
        loop.adamw_update = real
    assert not any(ops.launch_counts().values())
    assert abs(met["loss"].item() - want_met["loss"].item()) <= (
        1e-5 * abs(want_met["loss"].item()))
    want, _, _ = adamw_update(tree_map(lambda g: g.cpu(), seen[0]),
                              adamw_init(cpu_params), cpu_params, ocfg)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert (a.cpu() - b).abs().max().item() <= 1e-6 * b.abs().max().item()


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_remat_gradients_equal_no_remat_on_card(gen, arch):
    """Activation checkpointing recomputes the same operations: the card's
    gradients with ``remat=True`` equal ``remat=False``'s bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import tree_leaves
    from repro_torch.train import value_and_grad
    cfg = get_config(arch, reduced=True)
    params = on(build_model(cfg, device="cpu").init(0), "cuda")
    batch = on(_train_batch(cfg), "cuda")
    out = [value_and_grad(build_model(cfg, device="cuda", use_kernels=False,
                                      remat=r), params, batch)
           for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


def test_checkpoint_bf16_round_trip_onto_the_card(gen, tmp_path):
    """bf16 (stored as its uint16 bits), f32 and an int32 step from CUDA
    tensors, restored onto the card bit for bit."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.optim import adamw_init, tree_leaves
    params = {"w": torch.randn((64, 33), generator=gen,
                               device="cuda").to(torch.bfloat16),
              "blocks": [{"b": torch.randn(7, generator=gen,
                                           device="cuda")}]}
    tree = {"params": params, "opt": adamw_init(params)}
    ckpt.save(str(tmp_path), 4, tree)
    out = ckpt.restore(str(tmp_path), 4, tree)
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    cpu = ckpt.restore(str(tmp_path), 4, tree, device="cpu")
    assert all(x.device.type == "cpu" for x in tree_leaves(cpu))


def test_async_snapshot_of_cuda_tensors(gen, tmp_path):
    """``save_async`` copies the CUDA leaves to the host before it returns:
    an in-place change on the card afterwards does not reach the
    checkpoint."""
    from repro_torch import checkpoint as ckpt
    tree = {"a": torch.randn(1 << 20, generator=gen, device="cuda"),
            "b": torch.randn(999, generator=gen,
                             device="cuda").to(torch.bfloat16)}
    want = {k: v.clone() for k, v in tree.items()}
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save_async(1, tree)
    for v in tree.values():
        v.add_(1)
    ac.wait()
    out = ckpt.restore(str(tmp_path), 1, tree)
    for k in tree:
        assert out[k].device.type == "cuda" and torch.equal(out[k], want[k])
