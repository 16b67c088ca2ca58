"""The VLM family of the port (qwen2-vl) against the JAX package, on the CPU.

Reduced qwen2-vl-7b (float32, 2 layers, d_model 64, 4 heads / 2 KV heads
of 16, M-RoPE sections (2, 3, 3)).  The JAX package initialises it, the
QKV biases and norm scales are perturbed with seeded numpy values (JAX
initialises them to zeros and ones, so a bridge that dropped them would
still pass), and the same numpy weights feed both sides through
``params_from_jax``.  The JAX side runs its ``use_kernels=False`` paths;
the port runs on the CPU, where every kernel wrapper takes its plain
version.

M-RoPE is held to JAX on DISTINCT t/h/w streams: the grid that
``src/repro/data/pipeline.py:84-93`` builds for a vision prefix (t 0,
h and w the patch's row and column, text linear after it), so a wrong
section split shows.  On the serve paths the three streams are the text
positions, and M-RoPE equals RoPE.

Tolerances: M-RoPE 1e-6 (f32 elementwise); serve logits atol = rtol =
1e-4 and f32 pools 1e-5, as ``tests/test_torch_model.py`` holds the dense
family; engines: identical greedy tokens and equal counters.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import layers as L
from repro_torch.serve import Engine, ServeConfig, ServeRequest

pytestmark = pytest.mark.torch_port

ARCH = "qwen2-vl-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(atol=1e-5, rtol=1e-5)
MROPE = dict(atol=1e-6, rtol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def perturbed(np_params, seed=0):
    """Random QKV biases and norm scales (JAX inits zeros and ones)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.array, np_params)
    blocks = out["blocks"]["sub0"]
    for name in ("bq", "bk", "bv"):
        a = blocks["attn"][name]
        blocks["attn"][name] = (0.1 * rng.standard_normal(a.shape)).astype(
            a.dtype)
    for ln in ("ln1", "ln2"):
        a = blocks[ln]["scale"]
        blocks[ln]["scale"] = (1 + 0.1 * rng.standard_normal(a.shape)).astype(
            a.dtype)
    out["ln_f"]["scale"] = (
        1 + 0.1 * rng.standard_normal(out["ln_f"]["scale"].shape)
    ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH, reduced=True)
    jm = jax_build_model(jcfg, remat=False, use_kernels=False)
    np_params = perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    cfg = get_config(ARCH, reduced=True)
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_jax(np_params, cfg, "cpu"), np_params


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


def grid_positions(b, s, n_vis):
    """The data pipeline's M-RoPE positions (``pipeline.py:84-93``): a
    vision prefix of ``n_vis`` patches at t 0 on a square grid (h the row,
    w the column), text linear after it."""
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    grid = int(np.sqrt(n_vis))
    t_pos, h_pos, w_pos = pos.copy(), pos.copy(), pos.copy()
    h_pos[:, :n_vis] = np.arange(n_vis) // max(grid, 1)
    w_pos[:, :n_vis] = np.arange(n_vis) % max(grid, 1)
    t_pos[:, :n_vis] = 0
    return np.stack([t_pos, h_pos, w_pos]).astype(np.int32)


@pytest.mark.parametrize("d,sections,theta", [
    (16, (2, 3, 3), 1_000_000.0),        # the reduced config
    (128, (16, 24, 24), 1_000_000.0),    # qwen2-vl-7b's own
    (32, (8, 4, 4), 10_000.0),
])
@pytest.mark.parametrize("s,n_vis", [(40, 16), (300, 256)])
def test_apply_mrope_matches_jax_on_grid_streams(d, sections, theta, s,
                                                 n_vis):
    pos3 = grid_positions(2, s, n_vis)
    assert not (pos3[0] == pos3[1]).all() and not (pos3[1] == pos3[2]).all()
    x = np.random.default_rng(d + s).standard_normal(
        (2, s, 3, d)).astype(np.float32)
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                                     sections))
    got = L.apply_mrope(t(x), t(pos3), theta, sections)
    np.testing.assert_allclose(got.numpy(), want, **MROPE)
    # the streams are distinct: a section split other than the config's
    # rotates differently (what this test would catch)
    other = (sections[1], sections[0], sections[2])
    if other != sections:
        moved = L.apply_mrope(t(x), t(pos3), theta, other).numpy()
        assert np.abs(moved - want).max() > 1e-3


def test_apply_mrope_bf16_matches_jax():
    """bf16 input: rotated in f32 tables, rounded once to bf16 (JAX's
    cast rule)."""
    pos3 = grid_positions(2, 40, 16)
    x = np.random.default_rng(1).standard_normal((2, 40, 2, 16)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(JL.apply_mrope(xb, jnp.asarray(pos3), 1e6, (2, 3, 3))
                      .astype(jnp.float32))
    got = L.apply_mrope(t(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                        t(pos3), 1e6, (2, 3, 3))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 ** -8 * np.abs(want).max(), rtol=0)


def test_mrope_on_text_positions_equals_rope():
    """Text tokens (t == h == w) under M-RoPE are standard RoPE: the port's
    counterpart of ``tests/test_models.py``'s check."""
    x = t(np.random.default_rng(2).standard_normal((2, 8, 4, 16)).astype(
        np.float32))
    pos = torch.arange(8).expand(2, 8)
    a = L.apply_rope(x, pos, 1e4)
    b = L.apply_mrope(x, pos.expand(3, 2, 8), 1e4, (2, 3, 3))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **MROPE)
    cos_r, sin_r = L.rope_tables(pos, 16, 1e4)
    cos_m, sin_m = L.mrope_tables(pos.expand(3, 2, 8), 16, 1e4, (2, 3, 3))
    assert cos_m.shape == cos_r.shape == (2, 8, 1, 8)
    assert torch.equal(cos_r, cos_m) and torch.equal(sin_r, sin_m)


def test_mrope_sections_must_cover_half_the_head():
    pos3 = torch.zeros((3, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="sections"):
        L.mrope_tables(pos3, 16, 1e4, (2, 3, 2))


def test_serve_paths_take_the_mrope_route(models, monkeypatch):
    """The VLM model builds its rotation tables through ``mrope_tables``
    with three identical streams (JAX's broadcast of the text
    positions)."""
    _, _, tm, tp, _ = models
    seen = []
    real = L.mrope_tables

    def spy(pos3, *args):
        seen.append(pos3.clone())
        return real(pos3, *args)
    monkeypatch.setattr(L, "mrope_tables", spy)
    toks, lens = prompts(tm.cfg.vocab_size, LENS)
    tm.prefill(tp, t(toks), t(lens), states(None, tm, page_table(LENS))[1])
    assert len(seen) == 1 and seen[0].shape == (3, B, toks.shape[1])
    assert torch.equal(seen[0][0], seen[0][1])
    assert torch.equal(seen[0][1], seen[0][2])


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
    js = None if jm is None else jm.init_kv_state(
        b, frames, page, maxp)._replace(page_table=jnp.asarray(table))
    ts = tm.init_kv_state(b, frames, page, maxp)._replace(page_table=t(table))
    return js, ts


def assert_pools(ts, js, scratch=False, tol=F32):
    sl = slice(None, -1) if scratch else slice(None)
    for a, b in ((ts.k_pools, js.k_pools), (ts.v_pools, js.v_pools)):
        np.testing.assert_allclose(a.numpy()[:, sl], np.asarray(b)[:, sl],
                                   **tol)


def test_bridge_carries_biases_and_every_layer(models):
    _, _, tm, tp, np_params = models
    stacked = np_params["blocks"]["sub0"]
    assert len(tp["blocks"]) == tm.cfg.num_layers == 2
    for i, blk in enumerate(tp["blocks"]):
        for name in ("bq", "bk", "bv", "wq", "wo"):
            np.testing.assert_array_equal(blk["attn"][name].numpy(),
                                          stacked["attn"][name][i])
        np.testing.assert_array_equal(blk["ln1"]["scale"].numpy(),
                                      stacked["ln1"]["scale"][i])
    np.testing.assert_array_equal(tp["embed"].numpy(), np_params["embed"])
    np.testing.assert_array_equal(tp["head"].numpy(), np_params["head"])


def test_port_init_shapes():
    cfg = get_config(ARCH, reduced=True)
    tm = build_model(cfg, device="cpu")
    p = tm.init(0)
    assert tm.token_shape == ()
    assert p["embed"].shape == (cfg.vocab_size, cfg.d_model)
    assert p["head"].shape == (cfg.d_model, cfg.vocab_size)
    assert p["blocks"][0]["attn"]["bq"].shape == (
        cfg.num_heads * cfg.head_dim,)


@pytest.mark.parametrize("vision", [False, True])
def test_prefill_logits_and_pools(models, vision):
    """Prefill with and without a stub vision prefix: 5 precomputed patch
    embeddings (normal x 0.02, as the data pipeline draws them) replace
    the first 5 embedded positions of every row."""
    jm, jp, tm, tp, _ = models
    toks, lens = prompts(tm.cfg.vocab_size, LENS)
    js, ts = states(jm, tm, page_table(LENS))
    jkw, tkw = {}, {}
    if vision:
        vis = (np.random.default_rng(7).normal(
            size=(B, 5, tm.cfg.d_model)) * 0.02).astype(np.float32)
        jkw["vision_embeds"] = jnp.asarray(vis)
        tkw["vision_embeds"] = t(vis)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), js, **jkw)
    tl, ts = tm.prefill(tp, t(toks), t(lens), ts, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(ts.seq_lens.numpy(), lens)
    assert_pools(ts, js)
    if vision:   # the prefix changed what the text sees
        _, ts0 = states(None, tm, page_table(LENS))
        plain, _ = tm.prefill(tp, t(toks), t(lens), ts0)
        assert (plain - tl).abs().max() > 1e-3


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


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_decode_step_and_multi_step(models, kv_dtype):
    """Two decode steps, then a fused horizon of 3 with lanes retiring at
    3, 1 and 0 steps, on native and int8 pools."""
    jm, jp, tm, tp, _ = models
    if kv_dtype == "int8":
        jm, tm = _int8_twin(jm), _int8_twin(tm)
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
    if kv_dtype == "native":
        assert_pools(ts, js, scratch=True)
    steps = np.asarray([3, 1, 0], np.int32)
    jb, js, _ = jm.decode_multi_step(
        jp, jnp.asarray(tok), js, jnp.asarray(steps), jax.random.PRNGKey(0),
        jnp.float32(1.0), horizon=3, greedy=True)
    tb, ts = tm.decode_multi_step(tp, t(tok), ts, t(steps), None, 1.0,
                                  horizon=3, greedy=True)
    assert tb.shape == (3, B)
    for step in range(3):
        for lane in range(B):
            if step < steps[lane]:
                assert int(tb[step, lane]) == int(np.asarray(jb)[step, lane])
    np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                  np.asarray(js.seq_lens))
    if kv_dtype == "native":
        assert_pools(ts, js, scratch=True)


def _int8_twin(model):
    """A shallow copy on int8 pools (both packages' models take it)."""
    twin = copy.copy(model)
    twin.kv_dtype = "int8"
    return twin


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
    its first 8 tokens (radix hits on its two whole pages) and three
    ``share_prefix`` forks of it."""
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
    """The cold path in a pool small enough to preempt (and restore)."""
    kw = dict(TIGHT, prefix_cache=False, restore_patience=0,
              max_horizon=max_horizon, kv_dtype=kv_dtype)
    te = both(models, kw, mixed_workload(models[2].cfg.vocab_size))
    assert te.counters.get("preemptions") > 0


def test_default_policy_matches_jax_engine(models):
    """The default ``ServeConfig`` (radix prefix cache, partial restore) in
    the tight pool: preemptions, prefix hits."""
    te = both(models, dict(TIGHT), [
        (i, np.concatenate([base8, tail]), 12, False) for i, (base8, tail)
        in enumerate(_shared_base(models[2].cfg.vocab_size))])
    assert te.counters.get("prefix_hits") > 0
    assert te.counters.get("preemptions") > 0


def _shared_base(vocab, seed=13):
    """7 prompts: the first 8 tokens of one base and a 4-13-token tail."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=12).astype(np.int32)
    return [(base[:8], rng.integers(0, vocab, size=int(rng.integers(4, 14)))
             .astype(np.int32)) for _ in range(7)]


def test_radix_and_forks_match_jax_engine(models):
    """The default policy with forks of a preloaded prefix in one run."""
    prefix, wl = radix_fork_workload(models[2].cfg.vocab_size)
    kw = dict(page_size=4, num_pages=32, max_pages_per_seq=16, max_batch=3)
    te = both(models, kw, wl, prefix)
    assert te.counters.get("prefix_hits") > 0
    assert te.counters.get("forked_admissions") == 3


def test_aot_buckets_match_jax_engine(models):
    """Buckets of 8 and 16 tokens: equal ``aot_hits`` / ``aot_misses`` /
    ``bucket_pad_tokens`` (in COUNTERS) and tokens; a 13-token prompt
    beside a wider batch misses."""
    kw = dict(page_size=4, num_pages=64, max_pages_per_seq=16, max_batch=3,
              aot_buckets=(8, 12))
    te = both(models, kw, mixed_workload(models[2].cfg.vocab_size, n=5,
                                         max_new=6))
    assert te.counters.get("aot_hits") > 0
    assert te.counters.get("aot_misses") > 0
