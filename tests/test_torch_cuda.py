"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs a CUDA card and ``nvcc`` and skips with a
reason anywhere else (the CPU tests hold the plain versions against the
JAX package; these hold the kernels against the plain versions).  Run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 (both sides accumulate in f32 in different orders);
bf16 2e-2 (outputs round to bf16, one ulp is 2^-8 relative); the copy is
bit-identical.
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
