"""The route rules of the four kernels that have a tensor-core and a
CUDA-core kernel, and of the paged copy's and the paged gather's two
routes, on the CPU.

``matmul_route``, ``flash_route``, ``decode_route``, ``prefill_route``,
``copy_route`` and ``gather_route`` are pure functions of dtype, shape, strides and alignment,
decided before the launch; here they are held to their rules on CPU
tensors of the same layouts the card sees (the kernels themselves run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
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
from repro_torch.kernels.paged_copy import (
    copy_route,
    paged_copy as copy_kernel,
    paged_copy_at as copy_at_kernel,
    paged_copy_kv as copy_kv_kernel,
    paged_copy_kv_at as copy_kv_at_kernel,
)
from repro_torch.kernels.paged_attention import (
    decode_route,
    paged_decode_attention as decode_kernel,
)
from repro_torch.kernels.paged_gather import (
    alignment,
    gather_route,
    paged_gather as gather_kernel,
)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention as prefill_kernel,
    prefill_route,
    prefill_route_rule,
    query_block,
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
    decode_kernel.routes["mma"] += 1
    prefill_kernel.routes["wgmma"] += 4
    assert ops.route_counts()["paged_prefill_attention"]["wgmma"] >= 4
    copy_kernel.routes["burst"] += 2
    copy_at_kernel.routes["rows"] += 1
    assert ops.route_counts()["paged_copy_at"]["rows"] >= 1
    gather_kernel.routes["bulk"] += 1
    assert ops.route_counts()["paged_gather"]["bulk"] >= 1
    ops.reset_launch_counts()
    assert ops.route_counts() == {
        "paged_copy": {"burst": 0, "rows": 0},
        "flash_attention": {"wgmma": 0, "simt": 0},
        "paged_decode_attention": {"mma": 0, "simt": 0},
        "paged_copy_at": {"burst": 0, "rows": 0},
        "paged_prefill_attention": {"wgmma": 0, "simt": 0},
        "paged_gather": {"bulk": 0, "lanes": 0},
        "matmul": {"wgmma": 0, "simt": 0},
        "ragged_dot": {"mma": 0, "wgmma": 0, "simt": 0}}


# ---------------------------------------------------------------------------
# decode_route and prefill_route (the paged attention kernels)
# ---------------------------------------------------------------------------


def decode_operands(b=4, hkv=4, g=7, d=128, page=16, frames=72,
                    dtype=BF16, pool_dtype=None):
    """Decode operands as ``models/transformer.py`` passes them: q
    ``[B, Hkv, G, D]`` contiguous, one layer's pools ``[P, page, Hkv, D]``
    (a view into the layer stack)."""
    pool_dtype = pool_dtype or dtype
    q = aligned((b, hkv, g, d), dtype)
    pools = aligned((2, frames, page, hkv, d), pool_dtype)
    return q, pools[1], pools[0]


def prefill_q(b=3, s=240, hkv=4, g=7, d=128, dtype=BF16, width=None):
    """The ``[B, S, Hkv, G, D]`` view of the ``[B, S, Hq * D]`` projection
    (``width`` pads the row to another stride)."""
    width = width or hkv * g * d
    return aligned((b, s, width), dtype)[..., : hkv * g * d].view(
        b, s, hkv, g, d)


@pytest.mark.parametrize("pool_dtype", [BF16, torch.int8])
@pytest.mark.parametrize("b,hkv,g,d,page", [
    (4, 4, 7, 128, 16), (1, 4, 7, 128, 16), (2, 2, 1, 64, 8),
    (2, 2, 16, 64, 64), (2, 2, 8, 128, 32), (2, 2, 4, 80, 16)])
def test_decode_serve_operands_take_mma(pool_dtype, b, hkv, g, d, page):
    """bf16 queries over bf16 or int8 pools at the serve shapes and every
    G up to 16, pages of 8-64, D = 64, 80 (supported: a multiple of 16)
    and 128."""
    q, kp, vp = decode_operands(b, hkv, g, d, page, pool_dtype=pool_dtype)
    assert decode_route(q, kp, vp, page) == "mma"


@pytest.mark.parametrize("kw,why", [
    (dict(dtype=torch.float32), "f32"),
    (dict(d=14), "D = 14, the reduced configs'"),
    (dict(d=72), "D not a multiple of 16"),
    (dict(page=4), "page 4"),
    (dict(page=12), "page not a multiple of 8"),
    (dict(g=28, hkv=1), "G > 16"),
])
def test_decode_other_operands_take_simt(kw, why):
    args = dict(b=2, hkv=2, g=7, d=128, page=16)
    args.update(kw)
    dtype = args.pop("dtype", BF16)
    q, kp, vp = decode_operands(**args, dtype=dtype)
    assert decode_route(q, kp, vp, args["page"]) == "simt", why


def test_decode_misaligned_views_take_simt():
    q, kp, vp = decode_operands()
    assert decode_route(q, kp, vp, 16) == "mma"
    assert decode_route(misaligned(tuple(q.shape)), kp, vp, 16) == "simt"
    assert decode_route(q, misaligned(tuple(kp.shape)), vp, 16) == "simt"
    assert decode_route(q, kp, misaligned(tuple(vp.shape)), 16) == "simt"


@pytest.mark.parametrize("pool_dtype", [BF16, torch.int8])
@pytest.mark.parametrize("b,s,hkv,g,d,page", [
    (3, 240, 4, 7, 128, 16), (1, 80, 4, 7, 128, 16), (1, 1, 4, 7, 128, 16),
    (2, 37, 2, 1, 64, 8), (2, 37, 2, 16, 64, 64), (2, 37, 2, 8, 128, 32),
    (2, 37, 2, 4, 80, 16)])
def test_prefill_serve_views_take_wgmma(pool_dtype, b, s, hkv, g, d, page):
    """The ``[B, S, Hkv, G, D]`` view of the projection over bf16 or int8
    pools, every G up to 16, pages of 8-64, D = 64, 80 (supported: TMA
    zero-fills past D) and 128."""
    q = prefill_q(b, s, hkv, g, d)
    _, kp, vp = decode_operands(1, hkv, g, d, page, pool_dtype=pool_dtype)
    assert prefill_route(q, kp, vp, page) == "wgmma"
    assert prefill_route_rule(BF16, pool_dtype, g, d, page) == "wgmma"


@pytest.mark.parametrize("kw,why", [
    (dict(dtype=torch.float32), "f32"),
    (dict(d=14), "D = 14, the reduced configs'"),
    (dict(d=72), "D not a multiple of 16"),
    (dict(page=4), "page 4"),
    (dict(page=12), "page not a multiple of 8"),
    (dict(g=28, hkv=1), "G > 16"),
    (dict(g=32, hkv=1), "G > 16"),
])
def test_prefill_other_operands_take_simt(kw, why):
    args = dict(hkv=2, g=7, d=128, page=16)
    args.update(kw)
    dtype = args.pop("dtype", BF16)
    page = args.pop("page")
    q = prefill_q(2, 20, dtype=dtype, **args)
    _, kp, vp = decode_operands(1, page=page, dtype=dtype, **args)
    assert prefill_route(q, kp, vp, page) == "simt", why


def test_prefill_misaligned_views_take_simt():
    """A base off a 16-byte boundary on q or a pool; a token stride that
    is not a multiple of 8 elements."""
    q = prefill_q(2, 20, 2, 7, 128)
    _, kp, vp = decode_operands(1, 2, 7, 128, 16)
    assert prefill_route(q, kp, vp, 16) == "wgmma"
    mq = misaligned((2, 20, 2 * 7 * 128)).view(2, 20, 2, 7, 128)
    assert prefill_route(mq, kp, vp, 16) == "simt"
    assert prefill_route(q, misaligned(tuple(kp.shape)), vp, 16) == "simt"
    assert prefill_route(q, kp, misaligned(tuple(vp.shape)), 16) == "simt"
    odd = prefill_q(2, 20, 2, 7, 128, width=2 * 7 * 128 + 4)
    assert odd.stride(1) % 8 == 4
    assert prefill_route(odd, kp, vp, 16) == "simt"


@pytest.mark.parametrize("g,simt,wgmma", [
    (7, 9, 18), (4, 16, 32), (1, 64, 128), (8, 8, 16), (16, 4, 8),
    (2, 32, 64)])
def test_query_block_per_route(g, simt, wgmma):
    """Rows per block, 64 (CUDA cores) or 128 (tensor cores), as whole
    query tokens of the group."""
    assert query_block(g, "simt") == simt
    assert query_block(g, "wgmma") == wgmma


def test_executor_counts_with_the_route_rule():
    """The serve path's dtypes: full-width bf16 qwen2-7b (G = 7, D = 128,
    page 16) counts with the tensor-core block, native and int8 pools;
    the reduced f32 configs with the CUDA-core block."""
    assert prefill_route_rule(BF16, BF16, 7, 128, 16) == "wgmma"
    assert prefill_route_rule(BF16, torch.int8, 7, 128, 16) == "wgmma"
    assert prefill_route_rule(torch.float32, torch.float32, 2, 14, 4) \
        == "simt"
    assert prefill_route_rule(torch.float32, torch.int8, 2, 14, 4) == "simt"


def test_paged_attention_checks_unchanged():
    """Both wrappers still refuse what they refused, on both routes, and a
    refused call moves no counter."""
    q, kp, vp = decode_operands(2, 2, 7, 128, 16)
    table = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    qp = prefill_q(2, 20, 2, 7, 128)
    before = (decode_kernel.launches, dict(decode_kernel.routes),
              prefill_kernel.launches, dict(prefill_kernel.routes))
    with pytest.raises(TypeError):                       # int8 needs kv_scale
        ops.paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8),
                                   table, lens, page_size=16)
    with pytest.raises(ValueError):                      # G > 16
        ops.paged_decode_attention(*decode_operands(2, 1, 28, 128, 16),
                                   table, lens, page_size=16)
    with pytest.raises(ValueError):                      # pool page
        ops.paged_decode_attention(q, kp, vp, table, lens, page_size=8)
    with pytest.raises(ValueError):                      # CUDA only
        decode_kernel(q, kp, vp, table, lens, page_size=16)
    with pytest.raises(TypeError):                       # int8 needs kv_scale
        ops.paged_prefill_attention(qp, kp.to(torch.int8), vp.to(torch.int8),
                                    table, lens, page_size=16)
    with pytest.raises(ValueError):                      # pool page
        ops.paged_prefill_attention(qp, kp, vp, table, lens, page_size=8)
    with pytest.raises(ValueError):                      # CUDA only
        prefill_kernel(qp, kp, vp, table, lens, page_size=16)
    assert (decode_kernel.launches, dict(decode_kernel.routes),
            prefill_kernel.launches, dict(prefill_kernel.routes)) == before


# ---------------------------------------------------------------------------
# copy_route
# ---------------------------------------------------------------------------


def serve_copy_views(b, s, w, page, frames, dtype):
    """The model's views: a layer's K as ``[B, S, W]`` from the rotated
    projection, a layer of the ``[L, P, page, Hkv, D]`` pools as ``[P,
    page, W]``."""
    src = torch.zeros((b, s, w // 128, 128), dtype=dtype).reshape(b, s, w)
    pools = torch.zeros((2, frames, page, w // 128, 128), dtype=dtype)
    return src, pools[1].view(-1, page, w)


@pytest.mark.parametrize("dtype", [torch.float32, BF16, torch.int8])
@pytest.mark.parametrize("b,s,page", [(4, 368, 16), (3, 240, 16),
                                      (1, 1, 8), (2, 37, 4)])
def test_copy_route_serve_views_take_burst(dtype, b, s, page):
    """Rows adjacent on both sides, 16-byte aligned: the burst route, for
    one tensor and for K and V together."""
    k, kp = serve_copy_views(b, s, 512, page, 72, dtype)
    v, vp = serve_copy_views(b, s, 512, page, 72, dtype)
    assert copy_route((k,), (kp,)) == "burst"
    assert copy_route((k, v), (kp, vp)) == "burst"


@pytest.mark.parametrize("dtype", [torch.float32, BF16, torch.int8])
def test_copy_route_strided_or_misaligned_takes_rows(dtype):
    """Rows apart in src or in the frame, a base or a row not a multiple
    of 16 bytes, or one misaligned tensor of a pair: the rows route."""
    k, kp = serve_copy_views(2, 20, 512, 8, 16, dtype)
    wide = torch.zeros((2, 20, 1024), dtype=dtype)
    assert copy_route((wide[..., :512],), (kp,)) == "rows"
    assert copy_route((k,), (torch.zeros((16, 8, 1024), dtype=dtype)
                             [..., 512:],)) == "rows"
    assert copy_route((misaligned((2, 20, 512), dtype),), (kp,)) == "rows"
    assert copy_route((k,), (misaligned((16, 8, 512), dtype),)) == "rows"
    assert copy_route((k, misaligned((2, 20, 512), dtype)),
                      (kp, kp.clone())) == "rows"
    odd = 4 if dtype == torch.int8 else 2      # 4-byte rows
    assert copy_route((torch.zeros((2, 20, odd), dtype=dtype),),
                      (torch.zeros((16, 8, odd), dtype=dtype),)) == "rows"
    # a batch or frame stride off 16 bytes, rows still adjacent
    flat = torch.zeros(16 * 8 * 512 + 8 * 512, dtype=dtype)
    assert copy_route((k,), (flat.as_strided((16, 8, 512),
                                             (8 * 512 + 1, 512, 1)),)) \
        == "rows"


def test_copy_checks_unchanged_and_refusals_move_no_counter():
    """The pair wrappers refuse on the plain route and the kernel wrapper
    alike, and a refused call moves no counter."""
    k, kp = serve_copy_views(2, 20, 512, 8, 16, BF16)
    v, vp = serve_copy_views(2, 20, 512, 8, 16, BF16)
    table = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    before = (copy_kernel.launches, dict(copy_kernel.routes),
              copy_at_kernel.launches, dict(copy_at_kernel.routes))
    with pytest.raises(ValueError):                      # V 2 rows shorter
        ops.paged_copy_kv(k, v[:, :18], kp, vp, table, lens, page_size=8)
    with pytest.raises(TypeError):                       # int64 lens
        ops.paged_copy_kv_at(k, v, kp, vp, table, lens, lens.long(),
                             page_size=8)
    with pytest.raises(ValueError):                      # CUDA only
        copy_kv_kernel(k, v, kp, vp, table, lens, page_size=8)
    with pytest.raises(ValueError):                      # CUDA only
        copy_kv_at_kernel(k, v, kp, vp, table, lens, lens, page_size=8)
    assert (copy_kernel.launches, dict(copy_kernel.routes),
            copy_at_kernel.launches, dict(copy_at_kernel.routes)) == before


# ---------------------------------------------------------------------------
# gather_route (the paged gather)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row_bytes,align,route", [
    (1024, 16, "bulk"),       # qwen2-7b's K rows, bf16 W 512
    (64, 16, "bulk"),         # the smallest bulk row
    (16384, 16, "bulk"),      # the largest: two stages of 4 warps fit
    (2048, 16, "bulk"), (512, 16, "bulk"),
    (48, 16, "lanes"),        # narrow rows: the lanes copy is faster
    (16, 16, "lanes"),        # the quickstart's 4 f32
    (16400, 16, "lanes"),     # past the bulk stages
    (1024, 8, "lanes"), (1024, 4, "lanes"), (1024, 2, "lanes"),
    (1024, 1, "lanes"),       # a base or stride off 16 bytes
])
def test_gather_route_cases(row_bytes, align, route):
    assert gather_route(row_bytes, align) == route


@pytest.mark.parametrize("values,align", [
    ((0, 1024, 16384), 16), ((32, 48), 16), ((8, 1024), 8), ((12, 16), 4),
    ((2, 1024), 2), ((1024, 7), 1), ((2 ** 40 + 16, 2 ** 20), 16)])
def test_gather_alignment(values, align):
    assert alignment(*values) == align


def gather_views(pool):
    """What the wrapper hands ``gather_route``: the row's bytes and the
    alignment of the pool's base and strides (the output is a fresh
    allocation, 16-byte aligned)."""
    isz = pool.element_size()
    rb = pool.shape[2] * isz
    return rb, alignment(pool.data_ptr(), rb, pool.stride(0) * isz,
                         pool.stride(1) * isz)


@pytest.mark.parametrize("dtype,w,route", [
    (BF16, 512, "bulk"), (torch.float32, 512, "bulk"),
    (torch.int8, 512, "bulk"), (torch.int8, 64, "bulk"),
    (torch.float32, 4, "lanes"), (BF16, 4, "lanes"), (torch.int8, 4, "lanes"),
    (BF16, 7, "lanes"), (torch.float32, 14, "lanes")])
def test_gather_route_on_pools(dtype, w, route):
    """Contiguous pools and every other frame of a larger one take the
    route of their row; a view one element off its allocation takes
    lanes."""
    pool = torch.zeros((20, 16, w), dtype=dtype)
    assert gather_route(*gather_views(pool)) == route
    assert gather_route(*gather_views(pool[::2])) == route
    flat = torch.zeros(pool.numel() + 1, dtype=dtype)
    assert gather_route(*gather_views(flat[1:].view(pool.shape))) == "lanes"


def test_gather_refusals_move_no_counter():
    """The kernel wrapper refuses CPU tensors and bad operands before it
    counts anything."""
    pool = torch.zeros((4, 8, 512), dtype=BF16)
    row = torch.zeros(3, dtype=torch.int32)
    pos = torch.zeros(5, dtype=torch.int32)
    before = (gather_kernel.launches, dict(gather_kernel.routes))
    with pytest.raises(ValueError):                      # CUDA only
        gather_kernel(pool, row, pos, page_size=8)
    with pytest.raises(TypeError):                       # int64 positions
        gather_kernel(pool, row, pos.long(), page_size=8)
    assert (gather_kernel.launches, dict(gather_kernel.routes)) == before
