"""The port's RWKV-6 serve path against the JAX package, on the CPU.

Kernels: the port's plain versions of ``wkv6`` and ``wkv6_chunked`` (the
path a CPU tensor takes through ``ops.wkv6``) against the Pallas kernels
run in interpret mode and against the JAX oracle ``ref.wkv6_ref``, with
the shapes and tolerances of ``tests/test_kernels.py``: 1e-4 sequential,
3e-4 chunked, 1e-3 at a decay of 1e-6 (f32; the chunked form takes every
decay as an exp of a cumsum of logs, so it rounds differently from the
step loop).  ``ops.wkv6``'s route is held against the route JAX takes.

Model: the reduced rwkv6-7b (f32, 2 layers, d_model 32, heads of 16) is
initialised by the JAX package, its zero ``w_lora_B`` (which would leave
the data-dependent decay untested) and its unit norm scales are redrawn
with seeded numpy values, and the same numpy weights feed both sides
through ``params_from_jax``.  Prefill logits and every field of the
returned ``RecurrentState`` agree within 1e-4 (XLA and torch sum the
d_model contractions in different orders), greedy tokens are identical,
for both ``tm_impl``s and a ragged batch.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.wkv6_chunked import wkv6_chunked as jax_wkv6_chunked
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import (
    RecurrentState,
    RWKV6LM,
    build_model,
    params_from_jax,
)

jops = importlib.import_module("repro.kernels.ops")

pytestmark = pytest.mark.torch_port


def t(a):
    return torch.from_numpy(np.array(a))


def wkv_inputs(bh, tt, n, seed, decay_shift=0.0, state=False):
    """numpy r, k, v (scale 0.5), w = sigmoid(z + shift), u, and an
    optional [BH, N, N] initial state (scale 0.1)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    r, k, v = f(bh, tt, n, sc=0.5), f(bh, tt, n, sc=0.5), f(bh, tt, n, sc=0.5)
    w = (1 / (1 + np.exp(-(f(bh, tt, n) + decay_shift)))).astype(np.float32)
    u = f(bh, n, sc=0.5)
    s0 = f(bh, n, n, sc=0.1) if state else None
    return r, k, v, w, u, s0


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def port_args(*arrays):
    return [None if a is None else t(a) for a in arrays]


# ---------------------------------------------------------------------------
# the sequential kernel's plain version
# ---------------------------------------------------------------------------


class TestWKV6:
    @pytest.mark.parametrize("bh,tt,n", [(2, 32, 16), (4, 48, 16),
                                         (1, 128, 64)])
    @pytest.mark.parametrize("state", [False, True])
    def test_vs_pallas_and_oracle(self, bh, tt, n, state):
        arrs = wkv_inputs(bh, tt, n, seed=tt * n, state=state)
        j_in = [None if a is None else jnp.asarray(a) for a in arrs]
        o_k, s_k = jops.wkv6(*j_in, bt=16)              # Pallas, interpret
        o_r, s_r = jref.wkv6_ref(*j_in)
        o, s = ops.wkv6(*port_args(*arrs))
        for want_o, want_s in ((o_k, s_k), (o_r, s_r)):
            close(o.numpy(), want_o, 1e-4)
            close(s.numpy(), want_s, 1e-4)
        assert o.dtype == s.dtype == torch.float32

    def test_unaligned_t(self):
        """T = 27: the JAX wrapper pads with identity steps; the port's
        kernel and plain version take any T."""
        arrs = wkv_inputs(2, 27, 8, seed=1)
        j_in = [None if a is None else jnp.asarray(a) for a in arrs]
        o_k, s_k = jops.wkv6(*j_in, bt=8)
        o, s = ops.wkv6(*port_args(*arrs))
        close(o.numpy(), o_k, 1e-4)
        close(s.numpy(), s_k, 1e-4)

    def test_state_handoff_equals_one_call(self):
        """The serving decode contract: two calls with the state handed
        over equal one call, and both equal the Pallas kernel."""
        r, k, v, w, u, _ = port_args(*wkv_inputs(2, 64, 16, seed=2))
        o_full, s_full = ops.wkv6(r, k, v, w, u)
        o1, s1 = ops.wkv6(r[:, :40].contiguous(), k[:, :40].contiguous(),
                          v[:, :40].contiguous(), w[:, :40].contiguous(), u)
        o2, s2 = ops.wkv6(r[:, 40:].contiguous(), k[:, 40:].contiguous(),
                          v[:, 40:].contiguous(), w[:, 40:].contiguous(), u,
                          s1)
        close(torch.cat([o1, o2], 1).numpy(), o_full.numpy(), 1e-4)
        close(s2.numpy(), s_full.numpy(), 1e-4)
        o_k, s_k = jops.wkv6(*(jnp.asarray(x.numpy())
                               for x in (r, k, v, w, u)), bt=16)
        close(o_full.numpy(), o_k, 1e-4)
        close(s_full.numpy(), s_k, 1e-4)

    def test_out_state_is_written_in_place(self):
        r, k, v, w, u, s0 = port_args(*wkv_inputs(2, 5, 16, seed=3,
                                                  state=True))
        want_o, want_s = ops.wkv6(r, k, v, w, u, s0)
        s_in = s0.clone()
        o, s = ops.wkv6(r, k, v, w, u, s_in, out_state=s_in)
        assert s.data_ptr() == s_in.data_ptr()
        torch.testing.assert_close(s_in, want_s, atol=0, rtol=0)
        torch.testing.assert_close(o, want_o, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the chunked kernel's plain version
# ---------------------------------------------------------------------------


class TestWKV6Chunked:
    @pytest.mark.parametrize("bh,tt,n,chunk", [
        (2, 64, 16, 16), (4, 128, 16, 32), (1, 96, 32, 32)])
    def test_vs_pallas_and_oracle(self, bh, tt, n, chunk):
        arrs = wkv_inputs(bh, tt, n, seed=tt * n, decay_shift=-1.0,
                          state=True)
        j_in = [jnp.asarray(a) for a in arrs]
        o_k, s_k = jax_wkv6_chunked(*j_in, chunk=chunk)   # Pallas, interpret
        o_r, s_r = jref.wkv6_ref(*j_in)
        o, s = ref.wkv6_chunked_matmul_ref(*port_args(*arrs), chunk=chunk)
        for want_o, want_s in ((o_k, s_k), (o_r, s_r)):
            close(o.numpy(), want_o, 3e-4)
            close(s.numpy(), want_s, 3e-4)
        # the dispatcher's chunked route (chunk 32) on a CPU tensor
        o2, s2 = ops.wkv6(*port_args(*arrs), matmul_chunks=True)
        close(o2.numpy(), o_r, 3e-4)
        close(s2.numpy(), s_r, 3e-4)

    def test_extreme_decay_is_stable(self):
        """A decay of 1e-6 underflows to zero, never overflows: the mask
        is applied in log space before the exp."""
        r, k, v, w, u, _ = wkv_inputs(2, 64, 16, seed=4)
        w = np.full_like(w, 1e-6)
        j_in = [jnp.asarray(a) for a in (r, k, v, w, u)]
        o_k, s_k = jax_wkv6_chunked(*j_in, chunk=16)
        o_r, s_r = jref.wkv6_ref(*j_in)
        for chunk in (16, 32):
            o, s = ref.wkv6_chunked_matmul_ref(*port_args(r, k, v, w, u),
                                               chunk=chunk)
            assert torch.isfinite(o).all() and torch.isfinite(s).all()
            close(o.numpy(), o_r, 1e-3)
            close(s.numpy(), s_r, 1e-3)
            close(o.numpy(), o_k, 1e-3)
            close(s.numpy(), s_k, 1e-3)

    def test_unaligned_t_pads_with_identity_steps(self):
        """T = 27: padded with w = 1, k = 0 as JAX's chunked oracle pads."""
        arrs = wkv_inputs(2, 27, 16, seed=5, state=True)
        j_in = [jnp.asarray(a) for a in arrs]
        o_j, s_j = jref.wkv6_chunked_matmul_ref(*j_in, chunk=32)
        o, s = ref.wkv6_chunked_matmul_ref(*port_args(*arrs), chunk=32)
        close(o.numpy(), o_j, 3e-4)
        close(s.numpy(), s_j, 3e-4)
        o_r, s_r = jref.wkv6_ref(*j_in)
        close(o.numpy(), o_r, 3e-4)
        close(s.numpy(), s_r, 3e-4)


# ---------------------------------------------------------------------------
# the card kernel's algebra: sub-chunks with factored decays
# ---------------------------------------------------------------------------


def decay(x):
    """exp of a difference of cumulative log decays, clamped at 0 as the
    kernel clamps it (it is <= 0 in exact arithmetic)."""
    return torch.exp(torch.clamp(x, max=0.0))


def subchunk_wkv6(r, k, v, w, u, s0=None, chunk=32, sub=8):
    """The chunked recurrence as ``csrc/wkv6_chunked.cu`` computes it, in
    plain torch (f32).  Per chunk, ``cumx`` is the exclusive cumsum of
    ``log(max(w, 1e-38))`` with a leading 0 (``cumx[i] = ce_i``,
    ``cumx[j + 1] = cum_j``) and ``b_I = cumx[I sub]`` is ce at sub-block
    I's first row.  Each row is decayed to its own sub-block's boundaries
    only, ``rd_i = r_i exp(ce_i - b_I)`` and ``kf_j = k_j exp(b_{J+1} -
    cum_j)``; everything else is a per-channel factor between two
    boundaries.  An off-diagonal block (J < I) is ``rd_I (kf_J exp(b_I -
    b_{J+1}))^T``, a product with no exp inside; a diagonal block keeps one
    exp per (i, j, n), j < i; the bonus ``r_i . u k_i`` sits on A's
    diagonal; ``r_i exp(ce_i) = rd_i exp(b_I)`` and ``k_j exp(cum_last -
    cum_j) = kf_j exp(cum_last - b_{J+1})``.  T is padded with identity
    steps (w = 1, r = k = v = 0)."""
    bh, t, n = r.shape
    nc = -(-t // chunk)
    pad = nc * chunk - t
    f = lambda x, val=0.0: torch.nn.functional.pad(  # noqa: E731
        x.float(), (0, 0, 0, pad), value=val)
    r, k, v, w = f(r), f(k), f(v), f(w, 1.0)
    s = (s0.float().clone() if s0 is not None
         else torch.zeros((bh, n, n), dtype=torch.float32))
    nb = chunk // sub
    blk = torch.arange(chunk) // sub                       # row -> sub-block
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        rr, kk, vv = r[:, sl], k[:, sl], v[:, sl]
        lw = torch.log(torch.clamp(w[:, sl], min=1e-38))
        cumx = torch.cat([torch.zeros_like(lw[:, :1]),
                          torch.cumsum(lw, 1)], 1)        # [BH, C + 1, N]
        b = cumx[:, ::sub]                                # b_0 .. b_nb
        rd = rr * decay(cumx[:, :chunk] - b[:, blk])
        kf = kk * decay(b[:, blk + 1] - cumx[:, 1:])
        a = torch.zeros((bh, chunk, chunk), dtype=torch.float32)
        for bi in range(nb):
            rows = slice(bi * sub, (bi + 1) * sub)
            for ii in range(bi * sub, (bi + 1) * sub):     # mask before exp
                for jj in range(bi * sub, ii):
                    a[:, ii, jj] = (rr[:, ii] * kk[:, jj] * decay(
                        cumx[:, ii] - cumx[:, jj + 1])).sum(-1)
                a[:, ii, ii] = (rr[:, ii] * u.float() * kk[:, ii]).sum(-1)
            for bj in range(bi):
                cols = slice(bj * sub, (bj + 1) * sub)
                pair = decay(b[:, bi] - b[:, bj + 1])[:, None]
                a[:, rows, cols] = torch.einsum("bin,bjn->bij",
                                                rd[:, rows] * pair,
                                                kf[:, cols])
        ri = rd * decay(b[:, blk])
        ks = kf * decay(cumx[:, chunk:] - b[:, blk + 1])
        outs.append(torch.einsum("bin,bnm->bim", ri, s)
                    + torch.einsum("bij,bjm->bim", a, vv))
        s = decay(cumx[:, chunk])[:, :, None] * s + torch.einsum(
            "bjn,bjm->bnm", ks, vv)
    return torch.cat(outs, 1)[:, :t], s


def mixed_decays(bh, tt, n):
    """A per-channel mix of the extreme decays {1e-6, 0.5, 1 - 1e-6, 1}."""
    row = np.resize(np.array([1e-6, 0.5, 1 - 1e-6, 1.0], np.float32), n)
    return np.broadcast_to(row, (bh, tt, n)).copy()


@pytest.mark.parametrize("decays", ["sigmoid", "1e-6", "mixed"])
@pytest.mark.parametrize("n,tt", [(16, 96), (64, 64)])
def test_subchunk_factoring_vs_pallas_and_oracle(decays, n, tt):
    """The kernel's sub-chunk factoring against JAX ``wkv6_chunked``
    (interpret) and the step loop, with a carried state.  Tolerance 3e-4,
    the chunked tolerance: every decay is taken as an exp of a difference
    of f32 cumsums of logs, which rounds differently from the step loop's
    products; the factored form multiplies two such exps where the
    unfactored one takes one.  At decays of 1e-6 the factors underflow to
    0 and must stay finite."""
    r, k, v, w, u, s0 = wkv_inputs(2, tt, n, seed=8 + n, decay_shift=-1.0,
                                   state=True)
    if decays == "1e-6":
        w = np.full_like(w, 1e-6)
    elif decays == "mixed":
        w = mixed_decays(2, tt, n)
    arrs = (r, k, v, w, u, s0)
    j_in = [jnp.asarray(a) for a in arrs]
    o, s = subchunk_wkv6(*port_args(*arrs))
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    o_k, s_k = jax_wkv6_chunked(*j_in, chunk=32)        # Pallas, interpret
    o_r, s_r = jref.wkv6_ref(*j_in)
    for want_o, want_s in ((o_k, s_k), (o_r, s_r)):
        close(o.numpy(), want_o, 3e-4)
        close(s.numpy(), want_s, 3e-4)


def test_subchunk_factoring_pads_a_ragged_chunk():
    """T = 27 and T = 45: identity steps pad the last chunk, as the
    kernel's zero-filled stage does; against the step loop."""
    for tt in (27, 45):
        arrs = wkv_inputs(3, tt, 8, seed=tt, state=True)
        o, s = subchunk_wkv6(*port_args(*arrs))
        o_r, s_r = jref.wkv6_ref(*(jnp.asarray(a) for a in arrs))
        close(o.numpy(), o_r, 3e-4)
        close(s.numpy(), s_r, 3e-4)


# ---------------------------------------------------------------------------
# the sequential card kernel's algebra: channel groups, the bonus folded
# ---------------------------------------------------------------------------


def tile_wkv6(r, k, v, w, u, s0=None, tn=8):
    """The step loop as ``csrc/wkv6.cu`` computes it, in plain torch (f32).
    The channels are cut into groups of ``tn`` (the kernel's tile: 8, one
    group at N = 8); each group's partial output is ``p v_j + sum_{i in
    group} r_i S_ij`` with ``p = sum_{i in group} r_i (u_i k_i)`` (the
    bonus folded as ``v_j sum_i r_i u_i k_i``), the channels taken in
    order; the groups' partials are summed as the shuffles sum them,
    pairing group q with q + G/2 first, then halving; then ``S = diag(w) S
    + k v^T``."""
    bh, t, n = r.shape
    ng = n // tn
    s = (s0.float().clone() if s0 is not None
         else torch.zeros((bh, n, n), dtype=torch.float32))
    ug = u.float().view(bh, ng, tn)
    outs = []
    for i in range(t):
        rg, kg = r[:, i].view(bh, ng, tn), k[:, i].view(bh, ng, tn)
        vv, sg = v[:, i], s.view(bh, ng, tn, n)
        p = torch.zeros((bh, ng), dtype=torch.float32)
        for a in range(tn):
            p = p + rg[..., a] * (ug[..., a] * kg[..., a])
        part = p[..., None] * vv[:, None, :]                # [BH, groups, N]
        for a in range(tn):
            part = part + rg[..., a, None] * sg[:, :, a]
        while part.shape[1] > 1:
            half = part.shape[1] // 2
            part = part[:, :half] + part[:, half:]
        outs.append(part[:, 0])
        s = w[:, i, :, None] * s + k[:, i, :, None] * vv[:, None, :]
    return torch.stack(outs, 1), s


@pytest.mark.parametrize("decays", ["sigmoid", "mixed"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("tt", [1, 27, 64])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_tile_algebra_vs_pallas_and_oracle(n, tt, state, decays):
    """The kernel's order of sums against JAX ``wkv6`` (Pallas, interpret)
    and the JAX step loop, at every head size the kernel takes, with the
    per-channel extreme decays {1e-6, 0.5, 1 - 1e-6, 1}.  Tolerance 1e-5:
    all three run the same f32 steps and differ only in the order of the
    sum over channels and in where the bonus is added: a few f32 ulps of
    outputs of at most ~25 here (the decay-1 channels sum without decay)."""
    r, k, v, w, u, s0 = wkv_inputs(2, tt, n, seed=100 + n + tt, state=state)
    if decays == "mixed":
        w = mixed_decays(2, tt, n)
    arrs = (r, k, v, w, u, s0)
    j_in = [None if a is None else jnp.asarray(a) for a in arrs]
    o, s = tile_wkv6(*port_args(*arrs))
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    o_k, s_k = jops.wkv6(*j_in, bt=16)                  # Pallas, interpret
    o_r, s_r = jref.wkv6_ref(*j_in)
    for want_o, want_s in ((o_k, s_k), (o_r, s_r)):
        close(o.numpy(), want_o, 1e-5)
        close(s.numpy(), want_s, 1e-5)


# ---------------------------------------------------------------------------
# the dispatch rule
# ---------------------------------------------------------------------------

#: JAX's computation -> the port's route name
JAX_ROUTES = {"pallas_chunked": "wkv6_chunked", "pallas": "wkv6",
              "chunked_matmul_ref": "plain_chunked",
              "chunked_ref": "plain_sequential"}
#: the port's route -> the plain version a CPU tensor runs
PLAIN_OF = {"wkv6_chunked": "wkv6_chunked_matmul_ref",
            "plain_chunked": "wkv6_chunked_matmul_ref",
            "wkv6": "wkv6_ref", "plain_sequential": "wkv6_ref"}


@pytest.mark.parametrize("tt", [64, 27])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("matmul_chunks", [True, False])
def test_route_matches_jax(monkeypatch, tt, use_kernel, matmul_chunks):
    """``ops.wkv6`` takes the computation JAX ``ops.wkv6`` takes for every
    combination of ``matmul_chunks``, ``use_kernel`` and ``t % 32``; on a
    CPU tensor it runs that computation's plain version."""
    seen = []

    def spy(name):
        def fn(r, *a, **kw):
            seen.append(name)
            bh, tp, n = r.shape
            return jnp.zeros((bh, tp, n)), jnp.zeros((bh, n, n))
        return fn

    wkv6_chunked_mod = importlib.import_module("repro.kernels.wkv6_chunked")
    monkeypatch.setattr(wkv6_chunked_mod, "wkv6_chunked",
                        spy("pallas_chunked"))
    monkeypatch.setattr(jops, "_wkv6_kernel", spy("pallas"))
    monkeypatch.setattr(jref, "wkv6_chunked_matmul_ref",
                        spy("chunked_matmul_ref"))
    monkeypatch.setattr(jref, "wkv6_chunked_ref", spy("chunked_ref"))
    arrs = wkv_inputs(2, tt, 16, seed=6)
    with jax.disable_jit():
        jops.wkv6(*(jnp.asarray(a) for a in arrs[:5]), use_kernel=use_kernel,
                  matmul_chunks=matmul_chunks)
    assert len(seen) == 1
    route = ops.wkv6_route(tt, use_kernel=use_kernel,
                           matmul_chunks=matmul_chunks)
    assert route == JAX_ROUTES[seen[0]]

    called = []
    for name in ("wkv6_ref", "wkv6_chunked_matmul_ref"):
        real = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=real, **kw: (
            called.append((_n, kw.get("chunk"))) or _f(*a, **kw)))
    ops.wkv6(*port_args(*arrs[:5]), use_kernel=use_kernel,
             matmul_chunks=matmul_chunks)
    want = PLAIN_OF[route]
    assert called == [(want, 32 if want == "wkv6_chunked_matmul_ref"
                       else None)]


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_operands():
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked
    r, k, v, w, u, _ = port_args(*wkv_inputs(2, 4, 16, seed=7))
    for fn in (wkv6, wkv6_chunked):
        with pytest.raises(ValueError, match="CUDA"):
            fn(r, k, v, w, u)
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(r.transpose(0, 1).contiguous().transpose(0, 1), k, v, w, u)
    with pytest.raises(ValueError, match="head size"):
        ops.wkv6(r[..., :12].contiguous(), k[..., :12].contiguous(),
                 v[..., :12].contiguous(), w[..., :12].contiguous(),
                 u[:, :12].contiguous())
    with pytest.raises(ValueError, match="state"):
        ops.wkv6(r, k, v, w, u, torch.zeros(2, 16, 8))
    assert ops.launch_counts()["wkv6"] == 0
    assert ops.launch_counts()["wkv6_chunked"] == 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def perturbed(np_params, seed=0):
    """A nonzero ``w_lora_B`` (JAX inits zeros, which would leave the
    data-dependent decay untested) and non-unit norm scales."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.array, np_params)
    tm = out["blocks"]["tm"]
    tm["w_lora_B"] = (0.5 * rng.standard_normal(tm["w_lora_B"].shape)
                      ).astype(np.float32)
    tm["ln_x"] = (1 + 0.1 * rng.standard_normal(tm["ln_x"].shape)
                  ).astype(np.float32)
    for ln in ("ln1", "ln2"):
        a = out["blocks"][ln]["scale"]
        out["blocks"][ln]["scale"] = (1 + 0.1 * rng.standard_normal(a.shape)
                                      ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("rwkv6-7b", reduced=True)
    jm = jax_build_model(jcfg, remat=False)
    return perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))


def pair(weights, tm_impl):
    jcfg = jax_get_config("rwkv6-7b", reduced=True)
    jm = jax_build_model(jcfg, remat=False, use_kernels=True,
                         tm_impl=tm_impl)
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    cfg = get_config("rwkv6-7b", reduced=True)
    tm = build_model(cfg, device="cpu", tm_impl=tm_impl)
    tp = params_from_jax(weights, cfg, "cpu")
    return jm, jp, tm, tp


def prompts(vocab, lens, width, seed=3):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, np.asarray(lens, np.int32)


def assert_state_close(ts, js, tol=1e-4):
    assert isinstance(ts, RecurrentState)
    for name in ("tm_shift", "cm_shift", "wkv"):
        close(getattr(ts, name).numpy(), getattr(js, name), tol)
    np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                  np.asarray(js.seq_lens))
    assert ts.wkv.dtype == torch.float32 and ts.seq_lens.dtype == torch.int32


def test_bridge_unstacks_every_layer(weights):
    cfg = get_config("rwkv6-7b", reduced=True)
    tp = params_from_jax(weights, cfg, "cpu")
    assert len(tp["blocks"]) == cfg.num_layers == 2
    for i, blk in enumerate(tp["blocks"]):
        np.testing.assert_array_equal(blk["tm"]["w_lora_B"].numpy(),
                                      weights["blocks"]["tm"]["w_lora_B"][i])
        np.testing.assert_array_equal(blk["cm"]["wv"].numpy(),
                                      weights["blocks"]["cm"]["wv"][i])
        np.testing.assert_array_equal(blk["tm"]["u"].numpy(),
                                      weights["blocks"]["tm"]["u"][i])
    np.testing.assert_array_equal(tp["head"].numpy(), weights["head"])


@pytest.mark.parametrize("tm_impl,width,lens", [
    ("sequential", 27, [27, 27, 27]),
    ("chunked_matmul", 32, [32, 32, 32]),     # the chunked route
    ("chunked_matmul", 27, [27, 27, 27]),     # T % 32 != 0: sequential
    ("sequential", 32, [32, 20, 27]),         # ragged: JAX's padded tail
])
def test_prefill_then_greedy_decode_matches_jax(weights, tm_impl, width,
                                                lens):
    """Prefill logits and every state field within 1e-4, then 16 greedy
    decode steps with identical tokens, logits and states."""
    jm, jp, tm, tp = pair(weights, tm_impl)
    toks, pl = prompts(tm.cfg.vocab_size, lens, width)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(pl),
                        jm.init_state(len(lens)))
    tl, ts = tm.prefill(tp, t(toks), t(pl), tm.init_state(len(lens)))
    close(tl.numpy(), jl, 1e-4)
    assert_state_close(ts, js)
    np.testing.assert_array_equal(ts.seq_lens.numpy(), pl)
    for _ in range(16):
        tok_j = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        tok_t = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tok_t.numpy(), tok_j)
        jl, js = jm.decode_step(jp, jnp.asarray(tok_j), js)
        tl, ts = tm.decode_step(tp, tok_t, ts)
        close(tl.numpy(), jl, 1e-4)
    assert_state_close(ts, js)


def test_prefill_with_a_carried_state_matches_jax(weights):
    """A second prefill chunk continues from the first one's state."""
    jm, jp, tm, tp = pair(weights, "chunked_matmul")
    toks, pl = prompts(tm.cfg.vocab_size, [64, 64], 64, seed=8)
    jl, js = jm.prefill(jp, jnp.asarray(toks[:, :32]),
                        jnp.asarray(pl // 2), jm.init_state(2))
    tl, ts = tm.prefill(tp, t(toks[:, :32]), t(pl // 2), tm.init_state(2))
    jl, js = jm.prefill(jp, jnp.asarray(toks[:, 32:]), jnp.asarray(pl // 2),
                        js)
    tl, ts = tm.prefill(tp, t(toks[:, 32:]), t(pl // 2), ts)
    close(tl.numpy(), jl, 1e-4)
    assert_state_close(ts, js)
    np.testing.assert_array_equal(ts.seq_lens.numpy(), pl)


def test_golden_prefill_plus_decode_equals_forward(weights):
    """The port's own golden test (``tests/test_models.py:134-155``):
    recurrent-state serving equals the monolithic forward."""
    cfg = get_config("rwkv6-7b", reduced=True)
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(weights, cfg, "cpu")
    b, prompt = 2, 10
    rng = np.random.default_rng(9)
    tokens = t(rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32))
    state = tm.init_state(b)
    logits_p, state = tm.prefill(tp, tokens[:, :prompt],
                                 torch.full((b,), prompt, dtype=torch.int32),
                                 state)
    h, _ = tm.forward(tp, tokens[:, :prompt])
    torch.testing.assert_close(logits_p, (h @ tp["head"])[:, -1], atol=1e-5,
                               rtol=1e-5)
    for s in range(4):
        logits_d, state = tm.decode_step(tp, tokens[:, prompt + s], state)
        h, _ = tm.forward(tp, tokens[:, :prompt + s + 1])
        torch.testing.assert_close(logits_d, (h @ tp["head"])[:, -1],
                                   atol=1e-5, rtol=1e-5)
    assert state.seq_lens.tolist() == [prompt + 4] * b


def test_serve_calls_leave_the_given_state_unchanged(weights):
    cfg = get_config("rwkv6-7b", reduced=True)
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(weights, cfg, "cpu")
    st = tm.init_state(2)
    _, st = tm.prefill(tp, torch.ones((2, 5), dtype=torch.int32),
                       torch.full((2,), 5, dtype=torch.int32), st)
    before = [x.clone() for x in st]
    _, st2 = tm.decode_step(tp, torch.zeros(2, dtype=torch.int32), st)
    for a, b in zip(st, before):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert st2.nbytes == st.nbytes
    assert not torch.equal(st2.wkv, st.wkv)


def test_init_distributions_and_dtypes():
    """The port's seeded init draws the JAX package's distributions and
    keeps its dtypes: w0, w_lora_* and u f32 in a bf16 model, w_lora_B
    zero, unit norm scales; deterministic per seed."""
    import dataclasses
    cfg = dataclasses.replace(get_config("rwkv6-7b", reduced=True),
                              param_dtype="bfloat16")
    m = build_model(cfg, device="cpu")
    assert isinstance(m, RWKV6LM)
    p, p2 = m.init(0), m.init(0)
    torch.testing.assert_close(p["head"], p2["head"], atol=0, rtol=0)
    tm = p["blocks"][1]["tm"]
    for name in ("w0", "w_lora_A", "w_lora_B", "u"):
        assert tm[name].dtype == torch.float32, name
    for name in ("wr", "mu_r", "ln_x"):
        assert tm[name].dtype == torch.bfloat16, name
    assert float(tm["w_lora_B"].abs().max()) == 0.0
    assert -6.0 <= float(tm["w0"].min()) and float(tm["w0"].max()) <= -4.0
    assert -0.5 <= float(tm["u"].min()) and float(tm["u"].max()) <= 0.5
    assert tm["u"].shape == (cfg.num_rwkv_heads, cfg.rwkv_head_size)
    assert float(p["ln_f"]["scale"].min()) == 1.0
    st = m.init_state(3)
    assert st.tm_shift.dtype == torch.bfloat16
    assert st.wkv.shape == (2, 3, 2, 16, 16) and st.wkv.dtype == torch.float32


def test_engine_and_launcher_refuse_recurrent_families(monkeypatch):
    """Neither the engine nor the launcher serves a recurrent family, in
    the JAX launcher's words; the launcher refuses before building."""
    from repro_torch.launch import serve
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_config("rwkv6-7b", reduced=True)
    with pytest.raises(NotImplementedError,
                       match="recurrent families decode via "
                             "model.decode_step"):
        Engine(build_model(cfg, device="cpu"), None, ServeConfig())

    def no_build(*a, **kw):
        raise AssertionError("built a model")

    monkeypatch.setattr(serve, "build_model", no_build)
    for arch in ("rwkv6-7b", "recurrentgemma-9b"):
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
        with pytest.raises(SystemExit, match="engine drives paged-KV "
                                             "transformers"):
            serve.main()
