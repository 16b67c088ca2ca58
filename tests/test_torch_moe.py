"""The MoE family of the port against the JAX package, on the CPU.

Reduced granite-moe-1b-a400m (2 layers, 4 experts top-2, every layer
routes) and reduced llama4-maverick (2 layers, 8 experts top-1,
``moe_every = 2``: layer 0 dense, layer 1 routes), both float32.  The JAX
package initialises them, the norm scales are perturbed with seeded numpy
values (JAX initialises them to ones, so a bridge that dropped them, or
took a layer from the wrong superblock slot, would still pass), and the
same numpy weights feed both sides through ``params_from_jax``.  The JAX
side runs its ``use_kernels=False`` paths; the port runs on the CPU, where
``ops.ragged_dot`` takes its plain version.

Tolerances: the MoE functions 1e-5 (f32; XLA and torch sum the d_model
contractions in different orders), bf16 cast rules four bf16 steps of the
largest output; serve logits atol = rtol = 1e-4 and f32 pools 1e-5, as
``tests/test_torch_model.py`` holds the dense family; engines: identical
greedy tokens and equal counters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as JM
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ragged_dot import ragged_dot as ragged_dot_kernel
from repro_torch.kernels.ragged_dot import ragged_route
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import moe as M
from repro_torch.serve import Engine, ServeConfig, ServeRequest

pytestmark = pytest.mark.torch_port

ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def perturbed(np_params, seed=0):
    """Random norm scales in every superblock slot (JAX inits ones)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.array, np_params)
    for sub in out["blocks"].values():
        for ln in ("ln1", "ln2"):
            a = sub[ln]["scale"]
            sub[ln]["scale"] = (1 + 0.1 * rng.standard_normal(a.shape)
                                ).astype(a.dtype)
    out["ln_f"]["scale"] = (
        1 + 0.1 * rng.standard_normal(out["ln_f"]["scale"].shape)
    ).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = jax_get_config(request.param, reduced=True)
    jm = jax_build_model(jcfg, remat=False)
    np_params = perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    cfg = get_config(request.param, reduced=True)
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_jax(np_params, cfg, "cpu"), np_params


# ---------------------------------------------------------------------------
# the MoE functions
# ---------------------------------------------------------------------------


def moe_case(arch, dtype=jnp.float32, t_=37, seed=5):
    """One MoE layer's JAX params of ``arch`` (reduced) as numpy, the same
    on the torch side, and an input ``x [t_, D]``."""
    cfg = jax_get_config(arch, reduced=True)
    jp = JM.moe_init(jax.random.PRNGKey(seed), cfg, dtype)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    x = np.random.default_rng(seed).standard_normal(
        (t_, cfg.d_model)).astype(np.float32)
    tp = {k: t(v.astype(np.float32)).to(
        torch.float32 if k == "router" or dtype == jnp.float32
        else torch.bfloat16) for k, v in np_p.items()}
    return cfg, jp, tp, x


def kw(cfg):
    return dict(num_experts=cfg.num_experts, k=cfg.experts_per_token)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk(arch):
    cfg, jp, tp, x = moe_case(arch)
    ji, jg, ja = JM.router_topk(jp, jnp.asarray(x), cfg.experts_per_token)
    ti, tg, ta = M.router_topk(tp, t(x), cfg.experts_per_token)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    assert tg.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_sorted_with_drops(arch):
    """Capacity factor 0.5: assignments past capacity are dropped, exactly
    the ones JAX drops (stable sort, per-expert rank)."""
    cfg, jp, tp, x = moe_case(arch)
    jo, ja = JM.moe_apply_sorted(jp, jnp.asarray(x), capacity_factor=0.5,
                                 **kw(cfg))
    to, ta = M.moe_apply_sorted(tp, t(x), capacity_factor=0.5, **kw(cfg))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    dense, _ = M.moe_apply_dense(tp, t(x), **kw(cfg))
    dropped = (to - dense).abs().amax(-1) > 1e-4
    assert 0 < int(dropped.sum()) < x.shape[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_sorted_rows(arch):
    cfg, jp, tp, x = moe_case(arch, t_=39)
    xr = x.reshape(3, 13, -1)
    jo, ja = JM.moe_apply_sorted_rows(jp, jnp.asarray(xr),
                                      capacity_factor=2.0, **kw(cfg))
    to, ta = M.moe_apply_sorted_rows(tp, t(xr), capacity_factor=2.0,
                                     **kw(cfg))
    assert to.shape == xr.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_ragged_and_dense(arch):
    """The drop-free paths equal JAX's and each other (no capacity)."""
    cfg, jp, tp, x = moe_case(arch)
    jo, ja = JM.moe_apply_ragged(jp, jnp.asarray(x), **kw(cfg))
    to, ta = M.moe_apply_ragged(tp, t(x), **kw(cfg))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    jd, _ = JM.moe_apply_dense(jp, jnp.asarray(x), **kw(cfg))
    td, _ = M.moe_apply_dense(tp, t(x), **kw(cfg))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **F32)
    np.testing.assert_allclose(to.numpy(), td.numpy(), **F32)


def test_moe_apply_ragged_calls_ragged_dot_three_times(monkeypatch):
    """The ragged path calls ``ops.ragged_dot`` three times a dispatch with
    int32 group sizes that sum to T k (the CPU runs its plain version)."""
    cfg, _, tp, x = moe_case(ARCHS[0])
    seen = []
    real = ops.ragged_dot

    def spy(xs, w, gs, **kw_):
        seen.append((tuple(xs.shape), gs.dtype, int(gs.sum())))
        return real(xs, w, gs, **kw_)
    monkeypatch.setattr(ops, "ragged_dot", spy)
    M.moe_apply_ragged(tp, t(x), **kw(cfg))
    n = x.shape[0] * cfg.experts_per_token
    assert seen == [((n, cfg.d_model), torch.int32, n)] * 2 + [
        ((n, cfg.moe_d_ff), torch.int32, n)]


@pytest.mark.parametrize("sizes", [
    [5, 0, 12, 0], [0, 0, 17, 0], [17, 0, 0, 0], [3, 4, 2, 1], [0, 2, 0, 9]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_dot_plain_version_matches_jax(sizes, dtype):
    """Empty groups, one group holding every row, and rows past the last
    group (sizes summing below M = 20: those rows are zero)."""
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    xs = rng.standard_normal((20, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24, 16)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    jd = getattr(jnp, dtype)
    want = np.asarray(jax.lax.ragged_dot(
        jnp.asarray(xs, jd), jnp.asarray(w, jd), jnp.asarray(gs),
        preferred_element_type=jnp.float32))
    td = getattr(torch, dtype)
    got = ops.ragged_dot(t(xs).to(td), t(w).to(td), t(gs))
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        # both sum bf16 products in f32; the port rounds to bf16 once
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 ** -8 * np.abs(want).max(), rtol=0)
    assert not got[sum(sizes):].any()


def test_ragged_dot_checks():
    xs, w = torch.zeros((4, 8)), torch.zeros((3, 8, 5))
    gs = torch.tensor([1, 2, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.ragged_dot(xs, w[:, :4], gs)                 # K mismatch
    with pytest.raises(ValueError):
        ops.ragged_dot(xs, w, gs[:2])                    # E mismatch
    with pytest.raises(TypeError):
        ops.ragged_dot(xs, w, gs.long())                 # int64 sizes
    with pytest.raises(TypeError):
        ops.ragged_dot(xs, w.double(), gs)               # mixed dtypes
    with pytest.raises(ValueError):
        ops.ragged_dot(xs.t(), w.transpose(1, 2), gs)    # strided rows


def test_ragged_route_rule():
    """``ragged_route`` is a pure function of the dtype: bf16 takes the
    tensor cores, f32 the CUDA cores; bf16 operands the tensor-core kernel
    cannot address are refused on every device, the CPU's plain version
    included."""
    bf = torch.bfloat16
    xs = torch.zeros((64, 1024), dtype=bf)
    w = torch.zeros((32, 1024, 512), dtype=bf)
    gs = torch.tensor([64] + [0] * 31, dtype=torch.int32)
    assert ragged_route(xs, w) == "mma"
    assert ragged_route(xs.float(), w.float()) == "simt"
    assert ops.ragged_dot(xs, w, gs).shape == (64, 512)
    for x_, w_ in ((xs[:, :1020], w[:, :1020]),                   # K % 8
                   (xs, w[:, :, :500]),                            # N % 8
                   (torch.zeros((64, 1025), dtype=bf)[:, 1:], w),  # misaligned
                   (xs[:, :0], w[:, :0])):                         # K = 0
        with pytest.raises(ValueError, match="tensor cores only"):
            ops.ragged_dot(x_, w_, gs)
    # the same shapes in f32 take the CUDA-core kernel's plain version
    assert ops.ragged_dot(xs[:, :1020].float(), w[:, :1020].float(),
                          gs).shape == (64, 512)
    assert not ops.ragged_dot(xs[:, :0].float(), w[:, :0].float(), gs).any()


def test_ragged_dot_kernel_refuses_cpu_tensors():
    """The kernel wrapper launches or raises: no plain fallback."""
    xs, w = torch.zeros((4, 8)), torch.zeros((2, 8, 8))
    gs = torch.tensor([3, 1], dtype=torch.int32)
    before = ragged_dot_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ragged_dot_kernel(xs, w, gs)
    assert ragged_dot_kernel.launches == before


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_cast_rules(arch):
    """bf16 experts, f32 router: each path keeps JAX's cast rule (ragged:
    ``silu(gate) * up`` in f32, then x's dtype; sorted and dense: in x's
    dtype; combine in f32), within four bf16 steps of the largest output."""
    cfg, jp, tp, x = moe_case(arch, dtype=jnp.bfloat16)
    assert jp["router"].dtype == jnp.float32
    assert tp["router"].dtype == torch.float32
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = t(np.asarray(xb.astype(jnp.float32))).bfloat16()
    xr = xb.reshape(1, *xb.shape)
    cases = (
        (JM.moe_apply_ragged(jp, xb, **kw(cfg))[0],
         M.moe_apply_ragged(tp, tx, **kw(cfg))[0]),
        (JM.moe_apply_sorted(jp, xb, capacity_factor=2.0, **kw(cfg))[0],
         M.moe_apply_sorted(tp, tx, capacity_factor=2.0, **kw(cfg))[0]),
        (JM.moe_apply_sorted_rows(jp, xr, capacity_factor=2.0,
                                  **kw(cfg))[0][0],
         M.moe_apply_sorted_rows(tp, tx[None], capacity_factor=2.0,
                                 **kw(cfg))[0][0]),
        (JM.moe_apply_dense(jp, xb, **kw(cfg))[0],
         M.moe_apply_dense(tp, tx, **kw(cfg))[0]),
    )
    for jo, to in cases:
        assert to.dtype == torch.bfloat16
        want = np.asarray(jo.astype(jnp.float32))
        np.testing.assert_allclose(to.float().numpy(), want,
                                   atol=4 * 2 ** -8 * np.abs(want).max(),
                                   rtol=0)


def test_moe_init_distributions():
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    p = M.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["w_up"].shape == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    assert p["w_down"].shape == (cfg.num_experts, cfg.moe_d_ff, cfg.d_model)
    assert p["w_gate"].dtype == torch.bfloat16
    assert abs(float(p["w_up"].float().std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(float(p["w_down"].float().std()) * cfg.moe_d_ff ** 0.5
               - 1) < 0.1


# ---------------------------------------------------------------------------
# serve entry points
# ---------------------------------------------------------------------------

PAGE, N_PAGES, MAX_PAGES, B = 4, 24, 8, 3
LENS = [13, 6, 9]


def prompts(vocab, lens, page=PAGE, seed=3):
    rng = np.random.default_rng(seed)
    s = -(-max(lens) // page) * page
    toks = np.zeros((len(lens), s), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, np.asarray(lens, np.int32)


def page_table(lens, extra=2, page=PAGE, frames=N_PAGES, max_pages=MAX_PAGES,
               seed=4):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(frames - 1)
    table = np.full((len(lens), max_pages), -1, np.int32)
    for i, n in enumerate(lens):
        k = -(-(n + extra) // page)
        table[i, :k] = perm[i * max_pages: i * max_pages + k]
    return table


def states(jm, tm, table, page=PAGE, frames=N_PAGES):
    b, maxp = table.shape
    js = jm.init_kv_state(b, frames, page, maxp)._replace(
        page_table=jnp.asarray(table))
    ts = tm.init_kv_state(b, frames, page, maxp)._replace(page_table=t(table))
    return js, ts


def assert_pools(ts, js, scratch=False, tol=F32):
    sl = slice(None, -1) if scratch else slice(None)
    for a, b in ((ts.k_pools, js.k_pools), (ts.v_pools, js.v_pools)):
        np.testing.assert_allclose(a.numpy()[:, sl], np.asarray(b)[:, sl],
                                   **tol)


def test_bridge_interleaves_superblocks(models):
    """Layer i of the port is ``sub{i % m}[i // m]`` of the JAX pytree;
    only MoE layers hold experts."""
    jm, _, tm, tp, np_params = models
    m = jm.moe_every
    assert tm.moe_every == m
    for i, blk in enumerate(tp["blocks"]):
        sub = np_params["blocks"][f"sub{i % m}"]
        np.testing.assert_array_equal(blk["ln2"]["scale"].numpy(),
                                      sub["ln2"]["scale"][i // m])
        assert ("router" in blk["mlp"]) == tm.is_moe(i) == jm._is_moe_sub(
            i % m)
        for name in blk["mlp"]:
            np.testing.assert_array_equal(blk["mlp"][name].numpy(),
                                          sub["mlp"][name][i // m])


def test_prefill_logits_and_pools(models):
    jm, jp, tm, tp, _ = models
    toks, lens = prompts(tm.cfg.vocab_size, LENS)
    js, ts = states(jm, tm, page_table(LENS))
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), js)
    tl, ts = tm.prefill(tp, t(toks), t(lens), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_pools(ts, js)


def test_prefill_above_2048_tokens_takes_sorted_rows(models, monkeypatch):
    """Two rows of 1,040 (padded to 1,056) tokens: 2,112 > 2,048, so every
    MoE layer dispatches per row with capacity factor 2.0, as in JAX.  The
    pools after the first layer carry the layer's attention over 1,040
    keys, which JAX sums in 512-key chunks (``chunked_attention_ref``
    beyond 1,024 tokens) and the port in one softmax: held at the logits'
    1e-4."""
    jm, jp, tm, tp, _ = models
    page, frames, maxp = 16, 160, 72
    lens = [1040, 1031]
    toks, lens_ = prompts(tm.cfg.vocab_size, lens, page=page, seed=8)
    table = page_table(lens, page=page, frames=frames, max_pages=maxp)
    js, ts = states(jm, tm, table, page=page, frames=frames)
    calls = []
    real = M.moe_apply_sorted_rows

    def spy(p, x, **kw_):
        calls.append((tuple(x.shape), kw_["capacity_factor"]))
        return real(p, x, **kw_)
    monkeypatch.setattr(M, "moe_apply_sorted_rows", spy)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens_), js)
    tl, ts = tm.prefill(tp, t(toks), t(lens_), ts)
    n_moe = sum(tm.is_moe(i) for i in range(tm.cfg.num_layers))
    assert calls == [((2, toks.shape[1], tm.cfg.d_model), 2.0)] * n_moe
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_pools(ts, js, tol=TOL)


def test_prefill_continue(models):
    """Rows with 6 (mid-page), 8 (aligned) and 3 cached tokens extend by
    chunks of 7, 4 and 1 over random cached KV."""
    jm, jp, tm, tp, _ = models
    cfg, frames, maxp = tm.cfg, 24, 6
    rng = np.random.default_rng(11)
    starts = np.asarray([6, 8, 3], np.int32)
    chunks = np.asarray([7, 4, 1], np.int32)
    shape = (cfg.num_layers, frames, PAGE, cfg.num_kv_heads, cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    table = page_table(list(starts + chunks), extra=0, frames=frames,
                       max_pages=maxp, seed=12)
    toks, _ = prompts(cfg.vocab_size, list(chunks), seed=13)
    js, ts = states(jm, tm, table, frames=frames)
    js = js._replace(k_pools=jnp.asarray(kp), v_pools=jnp.asarray(vp))
    ts = ts._replace(k_pools=t(kp), v_pools=t(vp))
    jl, js = jm.prefill_continue(jp, jnp.asarray(toks), jnp.asarray(starts),
                                 jnp.asarray(chunks), js)
    tl, ts = tm.prefill_continue(tp, t(toks), t(starts), t(chunks), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(ts.seq_lens.numpy(), starts + chunks)
    assert_pools(ts, js)


def test_decode_step_and_multi_step(models):
    """Two decode steps, then a fused horizon of 3 with lanes retiring at
    3, 1 and 0 steps."""
    jm, jp, tm, tp, _ = models
    toks, lens = prompts(tm.cfg.vocab_size, LENS)
    js, ts = states(jm, tm, page_table(LENS, extra=6))
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), js)
    tl, ts = tm.prefill(tp, t(toks), t(lens), ts)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(2):
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js)
        tl, ts = tm.decode_step(tp, t(tok), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                      np.asarray(js.seq_lens))
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert_pools(ts, js, scratch=True)
    steps = np.asarray([3, 1, 0], np.int32)
    jb, js, _ = jm.decode_multi_step(
        jp, jnp.asarray(tok), js, jnp.asarray(steps), jax.random.PRNGKey(0),
        jnp.float32(1.0), horizon=3, greedy=True)
    tb, ts = tm.decode_multi_step(tp, t(tok), ts, t(steps), None, 1.0,
                                  horizon=3, greedy=True)
    for step in range(3):
        for lane in range(B):
            if step < steps[lane]:
                assert int(tb[step, lane]) == int(np.asarray(jb)[step, lane])
    np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                  np.asarray(js.seq_lens))
    assert_pools(ts, js, scratch=True)


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

COUNTERS = ("preemptions", "restores", "page_faults", "completed",
            "host_syncs", "decode_dispatches", "decode_horizon", "ptab_syncs",
            "ptab_rows_uploaded", "prefix_hits", "pages_reused",
            "prefill_tokens_skipped", "partial_restores", "pages_refilled",
            "forked_admissions", "fork_batches",
            "continuation_prefill_tokens", "prefill_bytes_gathered",
            "aot_hits", "aot_misses", "bucket_pad_tokens")
TIGHT = dict(page_size=4, num_pages=16, max_pages_per_seq=16, max_batch=3)


def mixed_workload(vocab, n=7, seed=13, max_new=12):
    """``tests/test_torch_serve.py``'s: 4-13-token prompts, 12 new."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(4, 14)))
             .astype(np.int32), max_new, False) for i in range(n)]


def radix_fork_workload(vocab, seed=17):
    """A preloaded 10-token prefix; four plain requests that start with
    its first 8 tokens (radix hits on its two whole pages: the pinned
    prefix is always resident) and three ``share_prefix`` forks of it."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=10).astype(np.int32)
    wl = [(i, np.concatenate([prefix[:8], rng.integers(0, vocab, size=int(
        rng.integers(3, 9))).astype(np.int32)]), 8, False) for i in range(4)]
    wl += [(4 + i, rng.integers(0, vocab, size=n).astype(np.int32), 6, True)
           for i, n in enumerate((3, 6, 9))]
    return prefix, wl


def run(engine_cls, request_cls, model, params, serve_cfg, workload,
        prefix=None):
    eng = engine_cls(model, params, serve_cfg)
    if prefix is not None:
        eng.preload_prefix(prefix)
    for i, prompt, max_new, share in workload:
        eng.submit(request_cls(req_id=i, prompt=prompt.copy(),
                               max_new_tokens=max_new, share_prefix=share))
    done = eng.run()
    eng.close()
    return eng, {i: [int(x) for x in r.output] for i, r in done.items()}


def both(models, kw, workload, prefix=None):
    jm, jp, tm, tp, _ = models
    je, jdone = run(JaxEngine, JaxServeRequest, jm, jp, JaxServeConfig(**kw),
                    workload, prefix)
    te, tdone = run(Engine, ServeRequest, tm, tp, ServeConfig(**kw), workload,
                    prefix)
    for c in COUNTERS:
        assert te.counters.get(c) == je.counters.get(c), c
    assert dataclasses.asdict(te.switcher.stats) == \
        dataclasses.asdict(je.executor.switcher.stats)
    assert sorted(tdone) == sorted(jdone) == [w[0] for w in workload]
    for i in jdone:
        assert tdone[i] == jdone[i], f"req {i} diverged from the JAX engine"
    te.vmem.check_invariants()
    assert te.counters.get("ref_path_dispatches") == 0
    return te


@pytest.mark.parametrize("max_horizon,kv_dtype",
                         [(1, "native"), (8, "native"), (8, "int8")])
def test_engine_matches_jax_engine(models, max_horizon, kv_dtype):
    """The cold path in a tight pool (preemption, restore)."""
    kw = dict(TIGHT, prefix_cache=False, restore_patience=0,
              max_horizon=max_horizon, kv_dtype=kv_dtype)
    te = both(models, kw, mixed_workload(models[2].cfg.vocab_size))
    assert te.counters.get("preemptions") > 0


def test_radix_and_forks_match_jax_engine(models):
    """The default policy (radix cache, partial restore) with forks of a
    preloaded prefix in one run."""
    prefix, wl = radix_fork_workload(models[2].cfg.vocab_size)
    kw = dict(page_size=4, num_pages=32, max_pages_per_seq=16, max_batch=3)
    te = both(models, kw, wl, prefix)
    assert te.counters.get("prefix_hits") > 0
    assert te.counters.get("forked_admissions") == 3


def test_aot_buckets_match_jax_engine(models):
    kw = dict(page_size=4, num_pages=64, max_pages_per_seq=16, max_batch=3,
              aot_buckets=(8, 16))
    te = both(models, kw, mixed_workload(models[2].cfg.vocab_size, n=5,
                                         max_new=6))
    assert te.counters.get("aot_hits") > 0


def test_plain_path_hatch_gives_the_same_tokens(models):
    """``use_ref_path`` runs the same MoE ops (the plain ``ragged_dot``
    is what the CPU runs anyway) and counts it."""
    _, _, tm, tp, _ = models
    wl = mixed_workload(tm.cfg.vocab_size, n=3, max_new=6)
    _, base = run(Engine, ServeRequest, tm, tp, ServeConfig(**TIGHT), wl)
    e1, hatch = run(Engine, ServeRequest, tm, tp,
                    ServeConfig(**TIGHT, use_ref_path=True), wl)
    assert hatch == base
    assert e1.counters.get("ref_path_dispatches") > 0


def test_int8_twin_shares_the_moe_weights(models):
    """The engine's int8 twin is a shallow copy of the model: same MoE
    layer rule, no copy of the experts."""
    _, _, tm, tp, _ = models
    eng = Engine(tm, tp, ServeConfig(**TIGHT, kv_dtype="int8"))
    twin = eng.executor._step_model
    assert twin is not tm and twin.kv_dtype == "int8"
    assert [twin.is_moe(i) for i in range(tm.cfg.num_layers)] == \
        [tm.is_moe(i) for i in range(tm.cfg.num_layers)]
    assert eng.executor.params is tp
    eng.close()
