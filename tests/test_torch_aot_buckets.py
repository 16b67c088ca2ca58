"""AOT-bucketed prefill in the port against the JAX engine.

Every scenario of ``tests/test_aot_buckets.py`` runs through both engines
on the same numpy prompts and the same weights (the JAX engine on its
``use_kernels=False`` reference paths, the port on the CPU, where its
kernel wrappers take their plain versions and each step program runs
eagerly over its static buffers): reduced qwen2-7b in f32, page 4, 64
frames, 16 pages a sequence, 3 lanes.  Greedy tokens and the bucket
counters (``aot_hits``, ``aot_misses``, ``bucket_pad_tokens``) and
``continuation_prefill_tokens`` must equal JAX's exactly.  The card's
CUDA graphs of the same programs are held against eager runs in
``tests/test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxServeRequest
from repro.serve.executor import select_bucket as jax_select_bucket
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import Engine, ServeConfig, ServeRequest
from repro_torch.serve import disable_graphs
from repro_torch.serve.executor import (
    _AOT_CACHE,
    StepProgram,
    horizon_ladder,
    select_bucket,
)

pytestmark = pytest.mark.torch_port

GEOM = dict(page_size=4, num_pages=64, max_pages_per_seq=16, max_batch=3)
BUCKET_COUNTERS = ("aot_hits", "aot_misses", "bucket_pad_tokens",
                   "continuation_prefill_tokens")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen2-7b", reduced=True)
    jm = jax_build_model(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    cfg = get_config("qwen2-7b", reduced=True)
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_jax(np_params, cfg, "cpu")


def prompts(vocab, lens):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def serve(engine_cls, request_cls, model, params, cfg, lens, *,
          prefix=None, share=False):
    """Serve one prompt per length (6 new tokens each), after preloading
    ``prefix`` if given; returns the engine and its greedy tokens."""
    eng = engine_cls(model, params, cfg)
    if prefix is not None:
        eng.preload_prefix(prefix)
    for i, p in enumerate(prompts(model.cfg.vocab_size, lens)):
        eng.submit(request_cls(prompt=p, max_new_tokens=6, req_id=i,
                               share_prefix=share))
    res = eng.drain()
    eng.close()
    return eng, {rid: [int(np.asarray(t)) for t in r.tokens]
                 for rid, r in res.items()}


def both(models, lens, buckets, **kw):
    """The same workload through the JAX and the port engine."""
    jm, jp, tm, tp = models
    je, jt = serve(JaxEngine, JaxServeRequest, jm, jp,
                   JaxServeConfig(aot_buckets=buckets, **GEOM), lens, **kw)
    te, tt = serve(Engine, ServeRequest, tm, tp,
                   ServeConfig(aot_buckets=buckets, **GEOM), lens, **kw)
    return je, jt, te, tt


def assert_counters_equal(je, te):
    for c in BUCKET_COUNTERS:
        assert te.counters.get(c) == je.counters.get(c), c


@pytest.mark.parametrize("n", [1, 4, 8, 9, 12, 16, 17, 40])
@pytest.mark.parametrize("buckets", [(8, 16), (8,), (16, 8, 8), None, ()])
def test_select_bucket_matches_jax(n, buckets):
    norm = None if buckets is None else tuple(sorted(set(buckets)))
    assert select_bucket(n, norm) == jax_select_bucket(n, norm)


def test_select_bucket_boundaries():
    assert select_bucket(8, (8, 16)) == 8
    assert select_bucket(9, (8, 16)) == 16
    assert select_bucket(16, (8, 16)) == 16
    assert select_bucket(17, (8, 16)) is None
    assert select_bucket(4, None) is None and select_bucket(4, ()) is None


def test_token_identity_and_no_misses(models):
    """Prompts spanning both buckets: tokens equal JAX's and the port's
    unbucketed run's; every prefill hits a bucket program."""
    lens = (5, 7, 4, 11, 8)
    je, jt, te, tt = both(models, lens, (8, 16))
    _, plain = serve(Engine, ServeRequest, *models[2:],
                     ServeConfig(**GEOM), lens)
    assert tt == jt == plain
    assert_counters_equal(je, te)
    assert te.counters.get("aot_hits") > 0
    assert te.counters.get("aot_misses") == 0
    assert te.counters.get("bucket_pad_tokens") > 0


def test_unbucketed_engine_counts_nothing(models):
    te, _ = serve(Engine, ServeRequest, *models[2:], ServeConfig(**GEOM),
                  (5, 9))
    assert te.counters.get("aot_hits") == te.counters.get("aot_misses") \
        == te.counters.get("bucket_pad_tokens") == 0
    assert te.executor._aot == {}


def test_exact_pad_accounting_single_request(models):
    """One 5-token prompt under bucket 8, 3 lanes: 3 rows x 8 columns
    minus 1 row of burst-aligned width 8 = 16 pad tokens, as in JAX."""
    je, jt, te, tt = both(models, (5,), (8,))
    assert tt == jt
    assert_counters_equal(je, te)
    assert te.counters.get("aot_hits") == 1
    assert te.counters.get("bucket_pad_tokens") == 3 * 8 - 1 * 8 == 16


def test_overlong_prompt_is_a_counted_miss(models):
    """Aligned width 12 > every bucket: the eager prefill runs, counted."""
    je, jt, te, tt = both(models, (9,), (8,))
    assert tt == jt
    assert_counters_equal(je, te)
    assert te.counters.get("aot_misses") == 1
    assert te.counters.get("aot_hits") == 0
    assert te.counters.get("bucket_pad_tokens") == 0


def test_continuation_prefill_rides_the_buckets(models):
    """``share_prefix`` forks prefill their chunks through the
    continuation program; tokens and counters equal JAX's."""
    prefix = np.random.default_rng(5).integers(
        0, models[2].cfg.vocab_size, size=8).astype(np.int32)
    je, jt, te, tt = both(models, (5, 6), (8,), prefix=prefix, share=True)
    assert tt == jt
    assert_counters_equal(je, te)
    assert te.counters.get("aot_misses") == 0
    assert te.counters.get("aot_hits") > 0
    assert te.counters.get("forked_admissions") == 2


def test_programs_equal_eager_steps(models):
    """On the CPU each step program runs eagerly over its static buffers;
    inside ``disable_graphs()`` the same steps run on fresh tensors.  Both
    give the same tokens and counters (the card's counterpart holds CUDA
    graphs against eager runs)."""
    _, _, tm, tp = models
    cfg = ServeConfig(aot_buckets=(8, 16), max_horizon=4, **GEOM)
    lens = (5, 7, 4, 11, 8)
    on, t_on = serve(Engine, ServeRequest, tm, tp, cfg, lens)
    with disable_graphs():
        off, t_off = serve(Engine, ServeRequest, tm, tp, cfg, lens)
    assert t_on == t_off
    assert dict(on.counters.counters) == dict(off.counters.counters)
    assert on.counters.get("decode_dispatches") > 0
    assert on.executor.replays == {}          # no graph on the CPU


class TestModuleCacheKeying:
    def test_same_twin_shares_new_twin_gets_its_own(self, models):
        """A second identical engine binds the same programs and adds
        nothing; a new bucket adds one program a kind; the int8 twin adds
        its own (a geometry no other test uses, so the deltas are exact)."""
        _, _, tm, tp = models
        geom = dict(GEOM, max_batch=2)
        a = Engine(tm, tp, ServeConfig(aot_buckets=(8,), **geom))
        n0 = len(_AOT_CACHE)
        b = Engine(tm, tp, ServeConfig(aot_buckets=(8,), **geom))
        assert len(_AOT_CACHE) == n0
        assert all(b.executor._aot[k] is a.executor._aot[k]
                   for k in a.executor._aot)
        wider = Engine(tm, tp, ServeConfig(aot_buckets=(8, 16), **geom))
        assert len(_AOT_CACHE) == n0 + 2
        assert wider.executor._aot[("prefill", 8)] is \
            a.executor._aot[("prefill", 8)]
        n1 = len(_AOT_CACHE)
        q = Engine(tm, tp, ServeConfig(aot_buckets=(8,), kv_dtype="int8",
                                       **geom))
        assert len(_AOT_CACHE) == n1 + 2
        assert q.executor._aot[("prefill", 8)] is not \
            a.executor._aot[("prefill", 8)]

    def test_program_buffers_have_the_bucket_shape(self, models):
        _, _, tm, tp = models
        eng = Engine(tm, tp, ServeConfig(aot_buckets=(8,), **GEOM))
        cont = eng.executor._aot[("continue", 8)].inputs
        assert cont["tokens"].shape == (3, 8)
        assert cont["pt_rows"].shape == (3, 16)
        assert {n: t.shape for n, t in cont.items()
                if n != "tokens" and n != "pt_rows"} == {
                    "lens": (3,), "starts": (3,)}


@pytest.mark.parametrize("max_horizon", [1, 2, 5, 8, 16])
def test_decode_programs_cover_the_horizon_ladder(models, max_horizon):
    """A decode program for every horizon the scheduler can plan (powers
    of two up to ``max_horizon``) and the K=1 step."""
    _, _, tm, tp = models
    eng = Engine(tm, tp, ServeConfig(max_horizon=max_horizon, **GEOM))
    planned = {1 << (k.bit_length() - 1) for k in range(1, max_horizon + 1)}
    want = {("decode", 1)} | {("decode_multi", k) for k in planned - {1}}
    assert set(eng.executor._programs) == want
    assert set(horizon_ladder(max_horizon)) == planned - {1}


def test_program_mask_and_load():
    prog = StepProgram(dict(
        tokens=((2, 4), torch.int32), pt_rows=((2, 3), torch.int32),
        active=((2,), torch.bool)), "cpu")
    prog.load(tokens=np.arange(8, dtype=np.int32).reshape(2, 4),
              pt_rows=torch.ones((2, 3), dtype=torch.int32),
              active=np.array([True, False]))
    assert prog.inputs["tokens"].tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert prog.inputs["active"].tolist() == [True, False]
    masked = prog.mask()
    assert masked["pt_rows"].eq(-1).all() and not masked["tokens"].any()
    assert not masked["active"].any()


def test_add_launch_counts():
    saved = ops.launch_counts(), ops.route_counts()
    ops.add_launch_counts({"paged_copy": 3, "flash_attention": 2},
                          {"paged_copy": {"burst": 3},
                           "flash_attention": {"wgmma": 2}})
    try:
        assert ops.launch_counts()["paged_copy"] == saved[0]["paged_copy"] + 3
        assert ops.route_counts()["flash_attention"]["wgmma"] == \
            saved[1]["flash_attention"]["wgmma"] + 2
    finally:
        ops.add_launch_counts({"paged_copy": -3, "flash_attention": -2},
                              {"paged_copy": {"burst": -3},
                               "flash_attention": {"wgmma": -2}})
    assert (ops.launch_counts(), ops.route_counts()) == saved
