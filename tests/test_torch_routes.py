"""The route rules of the two kernels that have a tensor-core and a
CUDA-core kernel, on the CPU.

``matmul_route`` and ``flash_route`` are pure functions of dtype, shape,
strides and alignment, decided before the launch; here they are held to
their rules on CPU tensors of the same layouts the card sees (the kernels
themselves run in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
The wrappers' input checks still refuse what they refused, on both the
plain route and the kernel wrapper, and a refused call moves no counter.
"""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention as flash_kernel,
    flash_route,
)
from repro_torch.kernels.matmul import (
    matmul as matmul_kernel,
    matmul_route,
    simt_config,
)

pytestmark = pytest.mark.torch_port

BF16 = torch.bfloat16


def aligned(shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype)


def misaligned(shape, dtype=BF16):
    """A view of ``shape`` whose base lies one element past a 16-byte
    boundary."""
    n = 1
    for s in shape:
        n *= s
    base = torch.zeros(n + 8, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[1: n + 1].view(shape)


# ---------------------------------------------------------------------------
# matmul_route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [
    (1, 4096, 4096), (129, 200, 264), (2048, 3584, 18944), (8, 1024, 8),
    (45, 64, 72), (128, 8, 8)])
@pytest.mark.parametrize("out_dtype", [None, torch.float32, BF16])
def test_matmul_aligned_bf16_takes_wgmma(m, k, n, out_dtype):
    """bf16 with row strides of a multiple of 8 and aligned bases, any M
    and ragged edges; the output type does not change the route."""
    x, y = torch.empty((m, k), dtype=BF16), torch.empty((k, n), dtype=BF16)
    assert matmul_route(x, y, out_dtype) == "wgmma"


@pytest.mark.parametrize("m,k,n", [
    (181, 181, 181), (45, 45, 45), (2048, 3584, 18944), (128, 128, 128)])
def test_matmul_f32_takes_simt(m, k, n):
    """f32 keeps true f32 FMAs on the CUDA cores at every shape."""
    x, y = torch.empty((m, k)), torch.empty((k, n))
    assert matmul_route(x, y) == "simt"
    assert matmul_route(x, y, BF16) == "simt"


@pytest.mark.parametrize("m,k,n", [
    (100, 70, 50), (64, 64, 50), (64, 70, 64), (3, 12, 4), (16, 1, 16)])
def test_matmul_bf16_stride_not_multiple_of_8_takes_simt(m, k, n):
    """A contiguous bf16 operand whose K (x's rows) or N (y's rows) is not
    a multiple of 8 has a row stride TMA cannot address."""
    x, y = aligned((m, k)), aligned((k, n))
    assert matmul_route(x, y) == "simt"


def test_matmul_misaligned_view_takes_simt():
    """A base pointer off a 16-byte boundary, on either operand."""
    x, y = aligned((64, 72)), aligned((72, 128))
    assert matmul_route(x, y) == "wgmma"
    assert matmul_route(misaligned((64, 72)), y) == "simt"
    assert matmul_route(x, misaligned((72, 128))) == "simt"


def test_matmul_strided_views():
    """A column slice keeps its parent's row stride: a stride of a multiple
    of 8 is addressable whatever the slice's width (TMA zero-fills past
    K), one that is not is not; K = 0 has nothing to stream."""
    parent = aligned((64, 128))
    y = aligned((70, 64))
    assert matmul_route(parent[:, :70], y) == "wgmma"
    assert matmul_route(aligned((64, 130))[:, :72], aligned((72, 64))) \
        == "simt"
    assert matmul_route(aligned((64, 0)), aligned((0, 64))) == "simt"


#: (m, k, n, dtype, tile, vec) of the CUDA-core kernel on a 132-SM H100:
#: every tile, with and without 16-byte copies in f32 (a K or N that is
#: not a multiple of 4 gives a row stride that is not 16 bytes), and the
#: bf16 operands TMA cannot address (bf16 never takes 16-byte copies)
SIMT_CASES = [
    (128, 128, 128, torch.float32, 16, True),
    (181, 181, 181, torch.float32, 16, False),
    (384, 384, 384, torch.float32, 32, True),
    (384, 383, 384, torch.float32, 32, False),
    (384, 384, 383, torch.float32, 32, False),
    (1024, 1024, 1024, torch.float32, 64, True),
    (1024, 1022, 1024, torch.float32, 64, False),
    (1536, 1536, 1536, torch.float32, 128, True),
    (1536, 1534, 1536, torch.float32, 128, False),
    (100, 70, 50, BF16, 16, False),
    (384, 383, 384, BF16, 32, False),
    (1000, 1002, 1002, BF16, 64, False),
    (1536, 1534, 1536, BF16, 128, False),
]


@pytest.mark.parametrize("m,k,n,dtype,tile,vec", SIMT_CASES)
def test_simt_config(m, k, n, dtype, tile, vec):
    """The largest tile that still gives each of 132 SMs a block; 16-byte
    copies for aligned f32 only; every case takes the CUDA-core route."""
    x, y = aligned((m, k), dtype), aligned((k, n), dtype)
    assert matmul_route(x, y) == "simt"
    assert simt_config(x, y, 132) == (tile, vec)


def test_simt_config_misaligned_and_sm_count():
    """A base off a 16-byte boundary loses the 16-byte copies; fewer SMs
    let the larger tiles fill the card sooner."""
    x, y = aligned((384, 384), torch.float32), aligned((384, 384),
                                                       torch.float32)
    assert simt_config(misaligned((384, 384), torch.float32), y, 132) \
        == (32, False)
    assert simt_config(x, misaligned((384, 384), torch.float32), 132) \
        == (32, False)
    assert simt_config(x, y, 9) == (128, True)
    assert simt_config(x, y, 10) == (64, True)


# ---------------------------------------------------------------------------
# flash_route
# ---------------------------------------------------------------------------


def serve_views(b, s, hq, hkv, d, dtype=BF16, sk=None):
    """``[B, S, H, D]`` memory seen as ``[B, H, S, D]``, as
    ``models/transformer.py`` passes q, k and v."""
    sk = s if sk is None else sk
    q = torch.empty((b, s, hq, d), dtype=dtype).transpose(1, 2)
    k = torch.empty((b, sk, hkv, d), dtype=dtype).transpose(1, 2)
    v = torch.empty((b, sk, hkv, d), dtype=dtype).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (4, 368, 28, 4, 128), (1, 4096, 28, 4, 128), (2, 1, 28, 4, 128),
    (2, 65, 4, 4, 128), (3, 240, 28, 4, 128), (2, 100, 8, 2, 64),
    (2, 100, 8, 2, 16)])
def test_flash_serve_views_take_wgmma(b, s, hq, hkv, d):
    """The serve path's transposed views (and any D multiple of 16 up to
    128) are addressable by TMA."""
    assert flash_route(*serve_views(b, s, hq, hkv, d)) == "wgmma"


def test_flash_contiguous_and_sq_lt_sk_take_wgmma():
    q = aligned((2, 8, 100, 128))
    k = aligned((2, 2, 300, 128))
    assert flash_route(q, k, k) == "wgmma"


@pytest.mark.parametrize("d", [14, 8, 72, 120])
def test_flash_head_dim_not_multiple_of_16_takes_simt(d):
    """The reduced configs' D = 14 and other dims off the 16-wide wgmma
    k-step."""
    assert flash_route(*serve_views(2, 20, 4, 2, d)) == "simt"


@pytest.mark.parametrize("s", [20, 368])
def test_flash_f32_takes_simt(s):
    """f32 stays on the CUDA cores (the reduced configs' f32 contract)."""
    assert flash_route(*serve_views(2, s, 4, 2, 128,
                                    dtype=torch.float32)) == "simt"


def test_flash_misaligned_views_take_simt():
    """A base off a 16-byte boundary on any of q, k, v; a head or token
    stride that is not a multiple of 8 elements; no keys."""
    q, k, v = serve_views(1, 70, 4, 4, 128)
    assert flash_route(q, k, v) == "wgmma"
    mq = misaligned((1, 70, 4, 128)).transpose(1, 2)
    assert flash_route(mq, k, v) == "simt"
    assert flash_route(q, mq, v) == "simt"
    assert flash_route(q, k, mq) == "simt"
    heads = torch.empty((1, 70, 4, 130), dtype=BF16)[..., :128]
    assert heads.stride(2) % 8 == 2                       # head stride 130
    assert flash_route(heads.transpose(1, 2), k, v) == "simt"
    tokens = torch.empty(70 * 516, dtype=BF16).as_strided(
        (1, 4, 70, 128), (70 * 516, 128, 516, 1))         # token stride 516
    assert flash_route(q, tokens, v) == "simt"
    q0, k0, v0 = serve_views(1, 4, 4, 4, 128, sk=0)
    assert flash_route(q0, k0, v0) == "simt"


# ---------------------------------------------------------------------------
# the checks still refuse what they refused
# ---------------------------------------------------------------------------


def test_matmul_checks_unchanged():
    x, y = aligned((64, 64)), aligned((64, 64))
    before = (matmul_kernel.launches, dict(matmul_kernel.routes))
    with pytest.raises(TypeError):                       # mixed dtypes
        ops.matmul(x, y.float())
    with pytest.raises(ValueError):                      # contraction
        ops.matmul(x, aligned((32, 64)))
    with pytest.raises(ValueError):                      # a transposed view
        ops.matmul(x, y.T)
    with pytest.raises(ValueError):                      # three dims
        ops.matmul(x[None], y)
    with pytest.raises(ValueError):                      # CUDA only
        matmul_kernel(x, y)
    assert (matmul_kernel.launches, dict(matmul_kernel.routes)) == before


def test_flash_checks_unchanged():
    q, k, v = serve_views(1, 16, 4, 4, 128)
    before = (flash_kernel.launches, dict(flash_kernel.routes))
    with pytest.raises(ValueError):                      # Hq % Hkv != 0
        ops.flash_attention(*serve_views(1, 16, 3, 2, 128))
    with pytest.raises(ValueError):                      # head_dim > 128
        ops.flash_attention(*serve_views(1, 16, 4, 4, 144))
    with pytest.raises(TypeError):                       # f16 is not taken
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):                       # mixed dtypes
        ops.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError):                      # D not contiguous
        ops.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):                      # causal Sq > Sk
        ops.flash_attention(*serve_views(1, 16, 4, 4, 128, sk=8))
    with pytest.raises(ValueError):                      # CUDA only
        flash_kernel(q, k, v)
    assert (flash_kernel.launches, dict(flash_kernel.routes)) == before


def test_route_counts_reset_with_launch_counts():
    """``ops.reset_launch_counts`` zeroes the per-route counts with the
    launches, and ``ops.route_counts`` reads both kernels'."""
    matmul_kernel.routes["wgmma"] += 3
    flash_kernel.routes["simt"] += 2
    assert ops.route_counts()["matmul"]["wgmma"] >= 3
    ops.reset_launch_counts()
    assert ops.route_counts() == {
        "flash_attention": {"wgmma": 0, "simt": 0},
        "matmul": {"wgmma": 0, "simt": 0}}
