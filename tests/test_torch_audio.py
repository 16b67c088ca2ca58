"""The audio family of the port (musicgen) against the JAX package, on the
CPU.

Reduced musicgen-large (float32, 2 layers, d_model 64, 4 heads / 4 KV
heads of 16, 4 codebooks of 64 tokens).  A token is ``[K]`` codebook
entries: the embedding sums K per-codebook rows, the head gives ``[K, V]``
logits and a decode lane samples K tokens.  The JAX package initialises
the model, its norm scales are perturbed with seeded numpy values (JAX
initialises them to ones, so a bridge that dropped them would still pass),
and the same numpy weights feed both sides through ``params_from_jax``.
The JAX side runs its ``use_kernels=False`` paths; the port runs on the
CPU, where every kernel wrapper takes its plain version.

Tolerances: embedding 1e-6 (a sum of four f32 rows), serve logits atol =
rtol = 1e-4 and f32 pools 1e-5, as ``tests/test_torch_model.py`` holds the
dense family; engines: identical greedy tokens and equal counters.
"""

import copy
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.transformer import sample
from repro_torch.serve import Engine, ServeConfig, ServeRequest

pytestmark = pytest.mark.torch_port

ARCH = "musicgen-large"
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def perturbed(np_params, seed=0):
    """Random norm scales (JAX inits ones)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.array, np_params)
    blocks = out["blocks"]["sub0"]
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


def int8_twin(model):
    """A shallow copy on int8 pools (both packages' models take it)."""
    twin = copy.copy(model)
    twin.kv_dtype = "int8"
    return twin


# ---------------------------------------------------------------------------
# embedding, head, bridge, sampling
# ---------------------------------------------------------------------------


def test_bridge_carries_stacked_embed_and_head(models):
    _, _, tm, tp, np_params = models
    cfg = tm.cfg
    k = cfg.num_codebooks
    assert tm.token_shape == (k,)
    assert tp["embed"].shape == (k, cfg.vocab_size, cfg.d_model)
    assert tp["head"].shape == (k, cfg.d_model, cfg.vocab_size)
    np.testing.assert_array_equal(tp["embed"].numpy(), np_params["embed"])
    np.testing.assert_array_equal(tp["head"].numpy(), np_params["head"])
    stacked = np_params["blocks"]["sub0"]
    for i, blk in enumerate(tp["blocks"]):
        np.testing.assert_array_equal(blk["ln2"]["scale"].numpy(),
                                      stacked["ln2"]["scale"][i])
        np.testing.assert_array_equal(blk["attn"]["wk"].numpy(),
                                      stacked["attn"]["wk"][i])


def test_port_init_shapes_and_distributions():
    cfg = get_config(ARCH, reduced=True)
    p = build_model(cfg, device="cpu").init(0)
    k = cfg.num_codebooks
    assert p["embed"].shape == (k, cfg.vocab_size, cfg.d_model)
    assert p["head"].shape == (k, cfg.d_model, cfg.vocab_size)
    # codebooks are drawn independently, with JAX's scales
    assert not torch.equal(p["embed"][0], p["embed"][1])
    assert abs(float(p["embed"].std()) / 0.02 - 1) < 0.1
    assert abs(float(p["head"].std()) * cfg.d_model ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("shape", [(5, 4), (3, 7, 4)])
def test_embed_sums_the_codebook_rows(models, shape):
    jm, jp, tm, tp, _ = models
    toks = np.random.default_rng(len(shape)).integers(
        0, tm.cfg.vocab_size, size=shape).astype(np.int32)
    want = np.asarray(jm.embed(jp, jnp.asarray(toks)))
    got = tm.embed(tp, t(toks))
    assert got.shape == shape[:-1] + (tm.cfg.d_model,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_logits_per_codebook(models):
    jm, jp, tm, tp, _ = models
    h = np.random.default_rng(4).standard_normal(
        (3, tm.cfg.d_model)).astype(np.float32)
    want = np.asarray(jm.logits_fn(jp, jnp.asarray(h)))
    got = tm.logits_fn(tp, t(h))
    assert got.shape == (3, tm.cfg.num_codebooks, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_sample_draws_one_gumbel_per_codebook_entry():
    """Greedy takes the last axis' argmax; a temperature draw uses one
    uniform of the logits' own ``[B, K, V]`` shape from the generator."""
    logits = torch.randn((3, 4, 64),
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(sample(logits, None, 1.0, True), logits.argmax(-1))
    gen = torch.Generator().manual_seed(5)
    got = sample(logits, gen, 0.7, False)
    assert got.shape == (3, 4)
    u = torch.rand((3, 4, 64), generator=torch.Generator().manual_seed(5))
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    assert torch.equal(got, (logits / 0.7 + gumbel).argmax(-1))


# ---------------------------------------------------------------------------
# serve entry points
# ---------------------------------------------------------------------------

PAGE, N_PAGES, MAX_PAGES = 4, 40, 8
LENS = [13, 6, 9]


def prompts(cfg, lens, page=PAGE, seed=3):
    """Padded ``[B, S, K]`` codebook prompts and their lengths."""
    rng = np.random.default_rng(seed)
    s = -(-max(lens) // page) * page
    toks = np.zeros((len(lens), s, cfg.num_codebooks), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, (n, cfg.num_codebooks))
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


def test_prefill_logits_and_pools(models):
    jm, jp, tm, tp, _ = models
    toks, lens = prompts(tm.cfg, LENS)
    js, ts = states(jm, tm, page_table(LENS))
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), js)
    tl, ts = tm.prefill(tp, t(toks), t(lens), ts)
    assert tl.shape == (3, tm.cfg.num_codebooks, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(ts.seq_lens.numpy(), lens)
    assert_pools(ts, js)


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
    toks, _ = prompts(cfg, list(chunks), seed=13)
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
    """Two decode steps of ``[B, K]`` tokens, then a fused horizon of 3
    with lanes retiring at 3, 1 and 0 steps."""
    jm, jp, tm, tp, _ = models
    if kv_dtype == "int8":
        jm, tm = int8_twin(jm), int8_twin(tm)
    toks, lens = prompts(tm.cfg, LENS)
    js, ts = states(jm, tm, page_table(LENS, extra=6))
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), js)
    _, ts = tm.prefill(tp, t(toks), t(lens), ts)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)    # [B, K]
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
    assert tb.shape == (3, 3, tm.cfg.num_codebooks)
    for step in range(3):
        for lane in range(3):
            if step < steps[lane]:
                np.testing.assert_array_equal(tb[step, lane].numpy(),
                                              np.asarray(jb)[step, lane])
    np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                  np.asarray(js.seq_lens))
    if kv_dtype == "native":
        assert_pools(ts, js, scratch=True)


def test_decode_multi_step_retires_lanes_at_b_equal_k(models):
    """4 lanes of 4 codebooks, the card's serve batch at musicgen's
    codebook count: ``[B]`` and ``[B, K]`` then line up, so a lane mask
    that broadcast along the codebook axis instead of the lane axis would
    run without an error and feed the wrong tokens back.  Lanes retire
    after 4, 1, 2 and 0 of 5 steps; every active lane's tokens, the
    lengths and the pools must equal JAX's (whose mask is reshaped to
    ``[B, 1]``)."""
    jm, jp, tm, tp, _ = models
    assert tm.cfg.num_codebooks == 4
    lens = [9, 5, 12, 7]
    toks, lens_ = prompts(tm.cfg, lens, seed=21)
    js, ts = states(jm, tm, page_table(lens, extra=6, seed=22))
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens_), js)
    _, ts = tm.prefill(tp, t(toks), t(lens_), ts)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)    # [4, 4]
    steps = np.asarray([4, 1, 2, 0], np.int32)
    jb, js, _ = jm.decode_multi_step(
        jp, jnp.asarray(tok), js, jnp.asarray(steps), jax.random.PRNGKey(0),
        jnp.float32(1.0), horizon=5, greedy=True)
    tb, ts = tm.decode_multi_step(tp, t(tok), ts, t(steps), None, 1.0,
                                  horizon=5, greedy=True)
    assert tb.shape == (5, 4, 4)
    jb = np.asarray(jb)
    for step in range(5):
        for lane in range(4):
            if step < steps[lane]:
                np.testing.assert_array_equal(tb[step, lane].numpy(),
                                              jb[step, lane])
    np.testing.assert_array_equal(ts.seq_lens.numpy(), lens_ + steps)
    np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                  np.asarray(js.seq_lens))
    assert_pools(ts, js, scratch=True)


# ---------------------------------------------------------------------------
# the Engine and the launcher
# ---------------------------------------------------------------------------

COUNTERS = ("preemptions", "restores", "page_faults", "completed",
            "host_syncs", "decode_dispatches", "decode_horizon", "ptab_syncs",
            "ptab_rows_uploaded", "prefix_hits", "pages_reused",
            "prefill_tokens_skipped", "partial_restores", "pages_refilled",
            "forked_admissions", "fork_batches",
            "continuation_prefill_tokens", "prefill_bytes_gathered",
            "aot_hits", "aot_misses", "bucket_pad_tokens")
TIGHT = dict(page_size=4, num_pages=16, max_pages_per_seq=16, max_batch=3)


def mixed_workload(cfg, n=7, seed=13, max_new=12):
    """4-13-frame prompts of K codebooks, 12 new frames."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, size=(int(rng.integers(
        4, 14)), cfg.num_codebooks)).astype(np.int32), max_new)
        for i in range(n)]


def shared_base_workload(cfg, seed=13):
    """7 prompts: the first 8 frames of one base and a 4-13-frame tail."""
    rng = np.random.default_rng(seed)
    k = cfg.num_codebooks
    base = rng.integers(0, cfg.vocab_size, size=(12, k)).astype(np.int32)
    return [(i, np.concatenate([base[:8], rng.integers(
        0, cfg.vocab_size, size=(int(rng.integers(4, 14)), k)).astype(
            np.int32)]), 12) for i in range(7)]


def run(engine_cls, request_cls, model, params, serve_cfg, workload):
    eng = engine_cls(model, params, serve_cfg)
    for i, prompt, max_new in workload:
        eng.submit(request_cls(req_id=i, prompt=prompt.copy(),
                               max_new_tokens=max_new))
    done = eng.run()
    eng.close()
    return eng, {i: np.asarray(r.output).tolist() for i, r in done.items()}


def both(models, kw, workload):
    jm, jp, tm, tp, _ = models
    je, jdone = run(JaxEngine, JaxServeRequest, jm, jp, JaxServeConfig(**kw),
                    workload)
    te, tdone = run(Engine, ServeRequest, tm, tp, ServeConfig(**kw), workload)
    for c in COUNTERS:
        assert te.counters.get(c) == je.counters.get(c), c
    assert dataclasses.asdict(te.switcher.stats) == \
        dataclasses.asdict(je.executor.switcher.stats)
    assert sorted(tdone) == sorted(jdone) == [w[0] for w in workload]
    for i, (_, _, max_new) in enumerate(workload):
        assert np.shape(tdone[i]) == (max_new, tm.cfg.num_codebooks)
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
    te = both(models, kw, mixed_workload(models[2].cfg))
    assert te.counters.get("preemptions") > 0


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_default_policy_matches_jax_engine(models, kv_dtype):
    """The default ``ServeConfig`` (radix prefix cache on, partial restore)
    in the tight pool, prompts sharing an 8-frame base: the same
    preemptions, restores and prefix hits as JAX's."""
    te = both(models, dict(TIGHT, kv_dtype=kv_dtype),
              shared_base_workload(models[2].cfg))
    assert te.counters.get("preemptions") > 0
    # radix hits on whole pages of [page, K] frames take the continuation
    # path; a partial restore needs a 1-D prompt stream (in both packages)
    assert te.counters.get("prefix_hits") > 0
    assert te.counters.get("partial_restores") == 0


def test_port_refuses_aot_buckets_with_audio(models):
    """AOT buckets take 1-D token prompts: the JAX engine fails while it
    builds them for an audio model, the port refuses when it is built."""
    _, _, tm, tp, _ = models
    with pytest.raises(ValueError, match="aot_buckets take 1-D token "
                                         "prompts"):
        Engine(tm, tp, ServeConfig(**TIGHT, aot_buckets=(8, 16)))


def test_launcher_serves_codebook_prompts(monkeypatch, capsys):
    """The port's launcher on reduced musicgen (the README's CPU line):
    ``[plen, K]`` prompts drawn as the JAX launcher draws them, every
    request done with ``[K]`` tokens a step, and the schedule's counters
    (which depend on lengths only) equal to the JAX launcher's on the same
    flags (``--no-kernels``: JAX's plain twin)."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    args = ["serve", "--arch", ARCH, "--requests", "4", "--num-pages", "9",
            "--page-size", "4", "--max-batch", "3", "--prompt-len", "20",
            "--max-new-tokens", "14"]
    seen = {}

    def tapped(engine_cls, key):
        class Tapped(engine_cls):
            def drain(self, *a, **kw):
                out = super().drain(*a, **kw)
                seen.setdefault(key, []).append((self, out))
                return out
        return Tapped

    monkeypatch.setattr(serve, "Engine", tapped(Engine, "port"))
    monkeypatch.setattr(sys, "argv", args + ["--device", "cpu"])
    serve.main()
    port_out = capsys.readouterr().out
    monkeypatch.setattr(jax_serve, "Engine", tapped(JaxEngine, "jax"))
    monkeypatch.setattr(sys, "argv", args + ["--no-kernels"])
    jax_serve.main()
    capsys.readouterr()
    te, tres = seen["port"][-1]         # the timed run (after the warm-up)
    je, jres = seen["jax"][-1]
    k = get_config(ARCH, reduced=True).num_codebooks
    assert len(tres) == len(jres) == 4
    for rid, r in tres.items():
        assert r.status == jres[rid].status
        assert np.array_equal(te.scheduler.done[rid].prompt,
                              je.scheduler.done[rid].prompt)
        assert te.scheduler.done[rid].prompt.shape[1:] == (k,)
        if r.status == "done":
            assert np.shape(r.tokens) == (14, k)
    done = sum(r.status == "done" for r in tres.values())
    assert f"completed {done}/4 requests" in port_out
    # a 20-frame prompt and 14 new frames need 9 pages of the 8 frames:
    # the reach check fails such a request in both packages
    for c in ("preemptions", "restores", "page_faults", "completed",
              "failed_unreachable", "decode_dispatches", "decode_horizon",
              "prefill_tokens"):
        assert te.counters.get(c) == je.counters.get(c), c
    assert te.counters.get("preemptions") > 0 and done >= 3
