"""The continuation path of the port against the JAX package, on the CPU.

Continuation prefill serves the default ``ServeConfig()``: the radix prefix
cache, the preloaded shared prefix with ``share_prefix`` forks, and partial
restore.  Inputs are made with numpy from a seed and fed to both sides; the
port runs on the CPU, where its kernel wrappers take their plain versions.
The JAX side runs as its own tests run it: Pallas in interpret mode on
small cases, ``repro.kernels.ref`` on the rest.

  * paged_copy_at: the whole pool bit-identical to the Pallas kernel and
    to the JAX oracle (f32 and int8), with unaligned and page-aligned
    starts, a chunk that touches both edge pages, a 1-token chunk, padded
    rows, -1 entries and tokens past the table; the pair dispatcher (K
    and V in one call) against two Pallas calls;
  * paged_prefill_attention: atol = rtol = 1e-5 in f32 on real rows (both
    sides accumulate in f32, only the summation order differs), for the
    cases of ``tests/test_paged_prefill_attention.py`` and int8 pools;
  * prefill_continue: the port against JAX (``use_kernels=False``) on the
    reduced qwen2-7b, native and int8;
  * the Engine with the default policy, forks of a preloaded prefix, and a
    temperature stream through a prefix hit; a spy shows ``prefill`` and
    ``prefill_continue`` dispatching one K/V copy a layer.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import paged_prefill_attention as jppa
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.kernels.paged_copy import paged_copy_at
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import Engine, ServeConfig, ServeRequest

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-5, rtol=1e-5)
KV_SCALE = 1 / 24


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# paged_copy_at
# ---------------------------------------------------------------------------

#: (starts, lens, S): row 0 starts mid-page and ends mid-page two pages on
#: (both edge pages read-modify-written), row 1 starts page-aligned, row 2
#: is a 1-token chunk, row 3 a padded row (lens < S) whose window crosses
#: an unmapped page, row 4 runs past the table (vpn >= max_pages).
COPY_CASES = {
    "edges": ([2, 8, 5, 7, 21], [9, 7, 1, 4, 6], 9),
    "aligned": ([0, 4, 12, 8, 20], [6, 3, 4, 5, 8], 8),
    "one_token": ([3, 0, 6, 13, 24], [1, 1, 1, 0, 1], 1),
}


def copy_case(seed, dtype, starts, lens, s):
    rng = np.random.default_rng(seed)
    b, w, page, frames, maxp = len(starts), 6, 4, 40, 6
    if dtype == np.int8:
        src = rng.integers(-127, 128, (b, s, w)).astype(np.int8)
        pool = rng.integers(-127, 128, (frames, page, w)).astype(np.int8)
    else:
        src = rng.standard_normal((b, s, w)).astype(dtype)
        pool = rng.standard_normal((frames, page, w)).astype(dtype)
    perm = rng.permutation(frames).astype(np.int32)
    table = perm[: b * maxp].reshape(b, maxp).copy()
    table[3, 2] = -1                       # row 3's second page is unmapped
    return src, pool, table, np.asarray(starts, np.int32), \
        np.asarray(lens, np.int32), page


class TestPagedCopyAt:
    @pytest.mark.parametrize("case", sorted(COPY_CASES))
    @pytest.mark.parametrize("dtype", [np.float32, np.int8])
    def test_whole_pool_bit_identical_to_pallas_and_oracle(self, case, dtype):
        src, pool, table, starts, lens, page = copy_case(
            len(case), dtype, *COPY_CASES[case])
        args = [jnp.asarray(a) for a in (src, pool, table, starts, lens)]
        kernel = np.asarray(jops.paged_copy_at(*args, page_size=page))
        oracle = np.asarray(jref.paged_copy_at_ref(*args, page_size=page))
        got = ops.paged_copy_at(t(src), t(pool), t(table), t(starts),
                                t(lens), page_size=page).numpy()
        np.testing.assert_array_equal(got, kernel)
        np.testing.assert_array_equal(got, oracle)

    @pytest.mark.parametrize("case", sorted(COPY_CASES))
    @pytest.mark.parametrize("dtype", [np.float32, np.int8])
    def test_pair_bit_identical_to_two_pallas_calls(self, case, dtype):
        """``ops.paged_copy_kv_at`` (plain route) writes K and V as two
        calls of JAX's ``ops.paged_copy_at`` (Pallas, interpret) do."""
        k_src, k_pool, table, starts, lens, page = copy_case(
            len(case) + 20, dtype, *COPY_CASES[case])
        v_src, v_pool, _, _, _, _ = copy_case(len(case) + 40, dtype,
                                              *COPY_CASES[case])
        want = [np.asarray(jops.paged_copy_at(
            *(jnp.asarray(a) for a in (src, pool, table, starts, lens)),
            page_size=page)) for src, pool in ((k_src, k_pool),
                                               (v_src, v_pool))]
        kp, vp = t(k_pool), t(v_pool)
        out = ops.paged_copy_kv_at(t(k_src), t(v_src), kp, vp, t(table),
                                   t(starts), t(lens), page_size=page)
        assert out[0] is kp and out[1] is vp
        np.testing.assert_array_equal(kp.numpy(), want[0])
        np.testing.assert_array_equal(vp.numpy(), want[1])

    def test_edge_pages_keep_their_other_rows(self):
        """Start 2, 9 tokens, page 4: rows 0-1 of the first page and row 3
        of the last page keep their bytes; nothing else moves."""
        src, pool, table, starts, lens, page = copy_case(
            9, np.float32, *COPY_CASES["edges"])
        got = ref.paged_copy_at_ref(t(src)[:1], t(pool), t(table)[:1],
                                    t(starts)[:1], t(lens)[:1],
                                    page_size=page).numpy()
        f0, f1, f2 = table[0, :3]
        np.testing.assert_array_equal(got[f0, :2], pool[f0, :2])
        np.testing.assert_array_equal(got[f0, 2:], src[0, :2])
        np.testing.assert_array_equal(got[f1], src[0, 2:6])
        np.testing.assert_array_equal(got[f2, :3], src[0, 6:9])
        np.testing.assert_array_equal(got[f2, 3:], pool[f2, 3:])
        others = np.setdiff1d(np.arange(pool.shape[0]), [f0, f1, f2])
        np.testing.assert_array_equal(got[others], pool[others])

    def test_updates_in_place_and_checks(self):
        src, pool, table, starts, lens, page = copy_case(
            3, np.float32, *COPY_CASES["aligned"])
        pool_t = t(pool)
        out = ops.paged_copy_at(t(src), pool_t, t(table), t(starts), t(lens),
                                page_size=page)
        assert out is pool_t and not np.array_equal(pool_t.numpy(), pool)
        with pytest.raises(TypeError):      # int64 starts
            ops.paged_copy_at(t(src), t(pool), t(table), t(starts).long(),
                              t(lens), page_size=page)
        with pytest.raises(TypeError):      # src dtype != pool dtype
            ops.paged_copy_at(t(src).double(), t(pool), t(table), t(starts),
                              t(lens), page_size=page)
        with pytest.raises(ValueError):     # wrong page size
            ops.paged_copy_at(t(src), t(pool), t(table), t(starts), t(lens),
                              page_size=8)
        with pytest.raises(ValueError):     # the kernel takes CUDA only
            paged_copy_at(t(src), t(pool), t(table), t(starts), t(lens),
                          page_size=page)


# ---------------------------------------------------------------------------
# paged_prefill_attention
# ---------------------------------------------------------------------------


def attn_case(page, starts, chunks, *, hkv=2, g=2, d=16, extra_frames=3,
              quant=False, seed=0):
    """Random pools and a table mapping ``pages_for(start + chunk)``
    shuffled frames per row, -1 beyond (numpy, as the JAX tests build
    theirs)."""
    rng = np.random.default_rng(seed)
    starts = np.asarray(starts, np.int32)
    chunks = np.asarray(chunks, np.int32)
    totals = starts + chunks
    max_pages = int(max(-(-int(n) // page) for n in totals))
    n_frames = len(starts) * max_pages + extra_frames
    shape = (n_frames, page, hkv, d)
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    frames = rng.permutation(n_frames)
    table = np.full((len(starts), max_pages), -1, np.int32)
    fi = 0
    for row, n in enumerate(totals):
        need = -(-int(n) // page)
        table[row, :need] = frames[fi: fi + need]
        fi += need
    q = rng.standard_normal(
        (len(starts), int(chunks.max()), hkv, g, d)).astype(np.float32)
    return q, kp, vp, table, starts, chunks


def check_attention(case, page, *, pallas: bool, kv_scale=None, bq=4):
    q, kp, vp, table, starts, chunks = case
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, starts)]
    got = ops.paged_prefill_attention(
        t(q), t(kp), t(vp), t(table), t(starts), page_size=page,
        kv_scale=kv_scale).numpy()
    wants = [np.asarray(jref.paged_prefill_attention_ref(
        *jargs, page_size=page, kv_scale=kv_scale))]
    if pallas:
        wants.append(np.asarray(jops.paged_prefill_attention(
            *jargs, page_size=page, kv_scale=kv_scale, bq=bq,
            use_kernel=True)))
    for want in wants:
        for row, chunk in enumerate(chunks):
            np.testing.assert_allclose(got[row, :chunk], want[row, :chunk],
                                       **TOL, err_msg=f"row {row}")


class TestPagedPrefillAttention:
    @pytest.mark.parametrize("page", [4, 8, 16])
    @pytest.mark.parametrize("chunk", [1, 3, 8, 17])
    @pytest.mark.parametrize("start", [0, 2, 5, 16])
    def test_grid_against_oracle(self, page, chunk, start):
        # start mid-page (2, 5) and page-aligned (0, 16); chunks across a
        # page boundary (3 at start 2, 17), a 1-token chunk
        case = attn_case(page, [start], [chunk], seed=page * 100 + chunk)
        check_attention(case, page, pallas=False)

    @pytest.mark.parametrize("start,chunk", [(0, 8), (5, 10), (2, 3)])
    def test_small_cases_against_pallas_kernel(self, start, chunk):
        # max_pages <= 6: the interpreted grid stays small
        case = attn_case(4, [start], [chunk], seed=start + chunk)
        assert case[3].shape[1] <= 6
        check_attention(case, 4, pallas=True)

    def test_batched_rows_with_distinct_offsets(self):
        case = attn_case(4, [5, 0, 9], [6, 1, 11], hkv=2, g=3, d=8, seed=3)
        assert case[3].shape[1] <= 6
        check_attention(case, 4, pallas=True)

    @pytest.mark.parametrize("g,hkv", [(1, 3), (2, 2), (4, 1)])
    def test_gqa_group_sizes(self, g, hkv):
        case = attn_case(4, [3, 7], [5, 5], hkv=hkv, g=g, d=8, seed=10 + g)
        check_attention(case, 4, pallas=True)

    @pytest.mark.parametrize("pallas", [False, True])
    def test_int8_pools(self, pallas):
        case = attn_case(4, [6, 2], [9, 4], quant=True, seed=21)
        check_attention(case, 4, pallas=pallas, kv_scale=KV_SCALE)

    def test_pages_touched_matches_jax(self):
        """The port's page count equals JAX's at the TPU kernel's bq = 32
        and at every query block the port's routes take (9 and 18 at
        qwen2-7b's G = 7, 16 and 32 at G = 4 and 8)."""
        for start in (0, 3, 16, 37):
            for chunk in (0, 1, 9, 32, 100):
                for max_pages in (2, 8, 40):
                    for page in (4, 16):
                        for bq in (1, 9, 16, 18, 32, 128):
                            kw = dict(page_size=page, bq=bq)
                            assert ppa.pages_touched(
                                start, chunk, max_pages, **kw) == \
                                jppa.pages_touched(start, chunk, max_pages,
                                                   **kw)
                            for qb in range(3):
                                assert ppa.last_reachable_page(
                                    start, qb, **kw) == \
                                    jppa.last_reachable_page(start, qb, **kw)
        assert ppa.query_block(7, "simt") == 9
        assert ppa.query_block(2, "simt") == 32
        assert ppa.query_block(7, "wgmma") == 18
        assert ppa.query_block(2, "wgmma") == 64
        assert ppa.query_block(16, "wgmma") == 8

    def test_checks(self):
        q, kp, vp, table, starts, _ = attn_case(4, [2], [5], seed=1)
        with pytest.raises(TypeError):      # int8 pools need kv_scale
            ops.paged_prefill_attention(
                t(q), t(kp).to(torch.int8), t(vp).to(torch.int8), t(table),
                t(starts), page_size=4)
        with pytest.raises(ValueError):     # pool page != page_size
            ops.paged_prefill_attention(t(q), t(kp), t(vp), t(table),
                                        t(starts), page_size=8)
        with pytest.raises(ValueError):     # the kernel takes CUDA only
            ppa.paged_prefill_attention(t(q), t(kp), t(vp), t(table),
                                        t(starts), page_size=4)


# ---------------------------------------------------------------------------
# prefill_continue
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen2-7b", reduced=True)
    jm = jax_build_model(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    cfg = get_config("qwen2-7b", reduced=True)
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_jax(np_params, cfg, "cpu")


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_prefill_continue_matches_jax(models, kv_dtype):
    """Rows with 6 (mid-page), 8 (aligned) and 3 cached tokens extend by
    chunks of 7, 4 and 1 over random cached KV."""
    jm, jp, tm, tp = models
    jm = copy.copy(jm)
    jm.kv_dtype = kv_dtype
    tm = build_model(tm.cfg, device="cpu", kv_dtype=kv_dtype)
    cfg, page, n_frames, max_pages = tm.cfg, 4, 24, 6
    rng = np.random.default_rng(11)
    starts = np.asarray([6, 8, 3], np.int32)
    chunks = np.asarray([7, 4, 1], np.int32)
    shape = (cfg.num_layers, n_frames, page, cfg.num_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        kp = rng.integers(-60, 61, shape).astype(np.int8)
        vp = rng.integers(-60, 61, shape).astype(np.int8)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(n_frames)
    table = np.full((3, max_pages), -1, np.int32)
    for i, n in enumerate(starts + chunks):
        table[i, : -(-int(n) // page)] = perm[i * max_pages:
                                               i * max_pages + -(-int(n) // page)]
    s = -(-int(chunks.max()) // page) * page
    toks = np.zeros((3, s), np.int32)
    for i, n in enumerate(chunks):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    jst = jm.init_kv_state(3, n_frames, page, max_pages)._replace(
        k_pools=jnp.asarray(kp), v_pools=jnp.asarray(vp),
        page_table=jnp.asarray(table))
    tst = tm.init_kv_state(3, n_frames, page, max_pages)._replace(
        k_pools=t(kp), v_pools=t(vp), page_table=t(table))
    jl, js = jm.prefill_continue(jp, jnp.asarray(toks), jnp.asarray(starts),
                                 jnp.asarray(chunks), jst)
    tl, ts = tm.prefill_continue(tp, t(toks), t(starts), t(chunks), tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(ts.seq_lens.numpy(), starts + chunks)
    for a, b in ((ts.k_pools, js.k_pools), (ts.v_pools, js.v_pools)):
        got, want = a.numpy(), np.asarray(b)
        if kv_dtype == "int8":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

#: the policy counters of ``tests/test_torch_serve.py`` plus the
#: continuation path's own
COUNTERS = ("preemptions", "restores", "page_faults", "completed",
            "host_syncs", "decode_dispatches", "decode_horizon", "ptab_syncs",
            "ptab_rows_uploaded", "prefix_hits", "pages_reused",
            "prefill_tokens_skipped", "partial_restores", "pages_refilled",
            "fork_batches", "continuation_prefill_tokens",
            "prefill_bytes_gathered")
FORK_COUNTERS = ("forked_admissions", "fork_batches",
                 "continuation_prefill_tokens", "preemptions", "restores",
                 "shared_restores", "completed", "prefill_bytes_gathered")


def shared_base_workload(vocab, n=7, seed=13, max_new=12):
    """Each prompt is the first 8 tokens of one 12-token base plus a
    4-13-token tail: two whole pages at page 4 for the radix cache."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=12).astype(np.int32)
    return [(i, np.concatenate([base[:8], rng.integers(
        0, vocab, size=int(rng.integers(4, 14))).astype(np.int32)]), max_new)
        for i in range(n)]


def run(engine_cls, request_cls, model, params, serve_cfg, workload,
        prefix=None, share=False):
    eng = engine_cls(model, params, serve_cfg)
    if prefix is not None:
        eng.preload_prefix(prefix)
    for i, prompt, max_new in workload:
        eng.submit(request_cls(req_id=i, prompt=prompt.copy(),
                               max_new_tokens=max_new, share_prefix=share))
    done = eng.run()
    eng.close()
    return eng, {i: [int(x) for x in r.output] for i, r in done.items()}


def assert_same(te, tdone, je, jdone, counters):
    for c in counters:
        assert te.counters.get(c) == je.counters.get(c), c
    assert dataclasses.asdict(te.switcher.stats) == \
        dataclasses.asdict(je.executor.switcher.stats)
    assert sorted(tdone) == sorted(jdone)
    for i in jdone:
        assert tdone[i] == jdone[i], f"req {i} diverged from the JAX engine"
    te.vmem.check_invariants()
    assert te.switcher.swapped_out == []
    assert te.counters.get("ref_path_dispatches") == 0


@pytest.mark.parametrize("max_horizon,kv_dtype",
                         [(1, "native"), (8, "native"), (8, "int8")])
def test_default_policy_engine_matches_jax_engine(models, max_horizon,
                                                  kv_dtype):
    """The default ``ServeConfig`` policy (radix prefix cache on,
    ``restore_patience=6``) in a tight pool: prefix hits and partial
    restores both fire, tokens and counters equal the JAX engine's."""
    jm, jp, tm, tp = models
    assert ServeConfig().prefix_cache and ServeConfig().restore_patience > 0
    kw = dict(page_size=4, num_pages=16, max_pages_per_seq=16, max_batch=3,
              max_horizon=max_horizon, kv_dtype=kv_dtype)
    wl = shared_base_workload(tm.cfg.vocab_size)
    je, jdone = run(JaxEngine, JaxServeRequest, jm, jp, JaxServeConfig(**kw),
                    wl)
    te, tdone = run(Engine, ServeRequest, tm, tp, ServeConfig(**kw), wl)
    assert te.counters.get("partial_restores") > 0
    assert te.counters.get("prefix_hits") > 0
    assert len(tdone) == len(wl)
    assert_same(te, tdone, je, jdone, COUNTERS)


def test_prefill_paths_dispatch_one_copy_a_layer(models, monkeypatch):
    """Spied on the default-policy workload: every ``prefill`` and
    ``prefill_continue`` dispatches one pair copy a layer
    (``ops.paged_copy_kv`` / ``ops.paged_copy_kv_at``) and no
    single-tensor copy, with tokens and counters still the JAX
    engine's."""
    jm, jp, tm, tp = models
    calls = dict.fromkeys(("prefill", "prefill_continue", "paged_copy_kv",
                           "paged_copy_kv_at", "paged_copy",
                           "paged_copy_at"), 0)

    def spy(owner, name):
        fn = getattr(owner, name)

        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(owner, name, counted)

    for name in ("paged_copy_kv", "paged_copy_kv_at", "paged_copy",
                 "paged_copy_at"):
        spy(ops, name)
    tm = build_model(tm.cfg, device="cpu")
    spy(tm, "prefill")
    spy(tm, "prefill_continue")
    kw = dict(page_size=4, num_pages=16, max_pages_per_seq=16, max_batch=3)
    wl = shared_base_workload(tm.cfg.vocab_size)
    je, jdone = run(JaxEngine, JaxServeRequest, jm, jp, JaxServeConfig(**kw),
                    wl)
    te, tdone = run(Engine, ServeRequest, tm, tp, ServeConfig(**kw), wl)
    layers = tm.cfg.num_layers
    assert calls["prefill"] > 0 and calls["prefill_continue"] > 0
    assert calls["paged_copy_kv"] == layers * calls["prefill"]
    assert calls["paged_copy_kv_at"] == layers * calls["prefill_continue"]
    assert calls["paged_copy"] == calls["paged_copy_at"] == 0
    assert te.counters.get("prefix_hits") > 0
    assert_same(te, tdone, je, jdone, COUNTERS)


#: the fork scenarios of ``tests/test_serve_executor.py``: (prefix length,
#: page, chunk lengths, max_new, seed, pool)
FORKS = {
    "prefix22_page4": (22, 4, [3, 6, 9], 8, 17, 64, 32),
    "prefix13_page8_one_batch": (13, 8, [1, 7, 12], 6, 23, 64, 16),
}


@pytest.mark.parametrize("name", sorted(FORKS))
def test_forks_match_jax_engine(models, name):
    jm, jp, tm, tp = models
    plen, page, chunks, max_new, seed, frames, maxp = FORKS[name]
    rng = np.random.default_rng(seed)
    vocab = tm.cfg.vocab_size
    prefix = rng.integers(0, vocab, size=plen).astype(np.int32)
    wl = [(i, rng.integers(0, vocab, size=n).astype(np.int32), max_new)
          for i, n in enumerate(chunks)]
    kw = dict(page_size=page, num_pages=frames, max_pages_per_seq=maxp,
              max_batch=4)
    je, jdone = run(JaxEngine, JaxServeRequest, jm, jp, JaxServeConfig(**kw),
                    wl, prefix=prefix, share=True)
    te, tdone = run(Engine, ServeRequest, tm, tp, ServeConfig(**kw), wl,
                    prefix=prefix, share=True)
    assert te.counters.get("forked_admissions") == 3
    assert te.counters.get("continuation_prefill_tokens") == sum(chunks)
    if name.endswith("one_batch"):
        assert te.counters.get("fork_batches") == 1
    assert_same(te, tdone, je, jdone, FORK_COUNTERS)


def test_spilled_fork_restores_shared_like_jax(models):
    """A fork spilled near the end of its decode re-shares the pinned
    prefix frame on restore instead of failing or spinning (the livelock
    scenario of ``tests/test_serve_executor.py``), on both engines."""
    jm, jp, tm, tp = models
    outs = []
    for engine_cls, request_cls, cfg_cls, m, p in (
            (JaxEngine, JaxServeRequest, JaxServeConfig, jm, jp),
            (Engine, ServeRequest, ServeConfig, tm, tp)):
        rng = np.random.default_rng(3)
        vocab = tm.cfg.vocab_size
        eng = engine_cls(m, p, cfg_cls(page_size=8, num_pages=10,
                                       max_pages_per_seq=12, max_batch=4))
        eng.preload_prefix(rng.integers(0, vocab, size=10).astype(np.int32))
        eng.submit(request_cls(
            req_id=0, prompt=rng.integers(0, vocab, size=30).astype(np.int32),
            max_new_tokens=24, share_prefix=True))
        for _ in range(100):
            eng.step()
            a = eng.scheduler.running.get(0)
            if a is not None and a.remaining == 1:
                break
        assert 0 in eng.scheduler.running
        eng.submit(request_cls(
            req_id=1, prompt=rng.integers(0, vocab, size=8).astype(np.int32),
            max_new_tokens=4))
        budget = eng.scheduler.step_i + 50
        done = eng.run(max_steps=budget)
        eng.close()
        assert eng.scheduler.step_i < budget and not eng.scheduler.has_work
        assert [done[i].status for i in (0, 1)] == ["done", "done"]
        assert eng.counters.get("shared_restores") == 1
        outs.append((eng, {i: [int(x) for x in r.output]
                           for i, r in done.items()}))
    (je, jdone), (te, tdone) = outs
    assert_same(te, tdone, je, jdone,
                FORK_COUNTERS + ("failed_unreachable",))


def test_prefix_hit_temperature_stream_identical_to_cold(models):
    """A radix hit replaces one cold prefill sample call with one
    continuation sample call, so the executor's generator is drawn in the
    same order and every stochastic token is the same, warm or cold."""
    _, _, tm, tp = models
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, tm.cfg.vocab_size, size=16).astype(np.int32)
    tails = [rng.integers(0, tm.cfg.vocab_size, size=5).astype(np.int32)
             for _ in range(2)]
    outs = {}
    for warm in (True, False):
        eng = Engine(tm, tp, ServeConfig(
            page_size=4, num_pages=64, max_pages_per_seq=16, max_batch=2,
            greedy=False, temperature=0.8, seed=3, prefix_cache=warm))
        eng.preload_prefix(prefix)
        streams = []
        for i, tail in enumerate(tails):
            eng.submit(ServeRequest(req_id=i,
                                    prompt=np.concatenate([prefix, tail]),
                                    max_new_tokens=6))
            streams.append([int(x) for x in eng.run()[i].output])
        outs[warm] = streams
        assert eng.counters.get("prefix_hits") == (2 if warm else 0)
        eng.close()
    assert outs[True] == outs[False]
