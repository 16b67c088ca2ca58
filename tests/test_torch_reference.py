"""The frozen seed engine of the port against the JAX package, on the CPU.

  * the whole-pool ``ContextSwitcher`` API (``spill`` / ``can_restore`` /
    ``restore`` with ``page_axis``) against JAX's, on a ``[P, page, W]``
    pool (page axis 0; numpy data, f32 and int8) and on the seed engine's
    flat ``[2L, P, page, Hkv, D]`` pool (page axis 1) written by each
    package's prefill of the reduced qwen2-7b (f32 and int8 pools): the
    records, the re-framed pool, ``SwitchStats`` field by field, both
    refusals of ``can_restore``, ``OutOfPagesError`` before anything moves
    and ``NotImplementedError`` for another axis;
  * ``ReferenceEngine`` against JAX's ``ReferenceEngine`` on the three
    workloads of ``tests/test_serve_executor.py`` (mixed preemption at page
    4 / 16 frames / 3 lanes, forks of a 22-token prefix at page 4,
    same-step forks of a 13-token prefix at page 8): greedy tokens, every
    counter, switch stats, pool stats and the snapshot FIFO;
  * ``ReferenceEngine`` against the port's ``Engine`` on the same
    workloads, held as ``TestSeedEquivalence`` and
    ``TestBatchedForkAdmission`` hold JAX's;
  * a temperature stream reproduced under one seed, and a CPU model's
    engine keeping every tensor on the CPU.

The JAX models run their ``use_kernels=False`` reference paths (the
default of ``build_model``); the port runs on the CPU, where its kernel
wrappers take their plain versions.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ReferenceEngine as JaxReferenceEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxServeRequest
from repro.serve.api import to_internal as jax_to_internal
from repro_torch import core as tcore
from repro_torch.configs import get_config
from repro_torch.core import vmem as tvmem
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import (
    Engine,
    ReferenceEngine,
    ServeConfig,
    ServeRequest,
    to_internal,
)

pytestmark = pytest.mark.torch_port

#: f32 K/V of the two frameworks' projections differ in the last bits
#: (ROADMAP Queue 3); copies of them are exact
F32_TOL = 2.1e-6


@pytest.fixture(scope="module")
def models():
    """``{kv_dtype: (jax model, jax params, port model, port params)}`` of
    the reduced qwen2-7b, one weight set."""
    jcfg = jax_get_config("qwen2-7b", reduced=True)
    jp = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(0))
    cfg = get_config("qwen2-7b", reduced=True)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return {kv: (jax_build_model(jcfg, remat=False, kv_dtype=kv), jp,
                 build_model(cfg, device="cpu", kv_dtype=kv), tp)
            for kv in ("native", "int8")}


# ---------------------------------------------------------------------------
# the whole-pool ContextSwitcher API
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Side:
    """One package's switcher, its VM and its pool, driven alike."""

    core: object
    pool: object
    page_axis: int

    def __post_init__(self):
        self.jax = self.core is jcore
        self.vm = self.core.VirtualMemory(self.core.VMemConfig(
            page_size=4, num_pages=6, max_pages_per_seq=4, max_seqs=2))
        self.cs = self.core.ContextSwitcher(self.vm, page_axis=self.page_axis)

    def np(self, a):
        return np.asarray(a) if self.jax else a.numpy()

    def dirty(self):
        """Overwrite every frame (the freed ones included) with -1."""
        if self.jax:
            self.pool = jnp.full_like(self.pool, -1)
        else:
            self.pool.fill_(-1)

    def stats(self):
        return dataclasses.asdict(self.cs.stats)


def run_whole_pool(side: Side, oom_check) -> dict:
    """Map seq 0 (10 tokens, 3 frames), spill it, dirty the pool, and
    restore it through both refusals of ``can_restore``: too few frames
    (seq 5 holds 4 of 6), then no slot (seqs 6 and 7 hold both; seq 7
    keeps one of seq 0's old frames).  Returns
    what the other package must match."""
    vm, cs = side.vm, side.cs
    vm.map_seq(0, 10)
    obs = {"old_pages": list(vm.seq(0).pages)}
    side.pool = side.cs.spill(0, side.pool, extra_state={"output": [3, 1]})
    obs["record"] = side.np(cs._swap[0].page_data)
    obs["spilled"] = side.stats()
    side.dirty()
    vm.map_seq(5, 16)
    obs["no_frames"] = cs.can_restore(0)
    oom_check(side)
    vm.unmap_seq(5)
    vm.map_seq(6, 4)
    vm.map_seq(7, 4)
    obs["no_slot"] = (cs.can_restore(0), vm.pool.num_free)
    vm.unmap_seq(6)             # seq 7 keeps frame 0: the restore re-frames
    obs["ready"] = cs.can_restore(0)
    side.pool, extra = cs.restore(0, side.pool)
    obs["extra"] = extra
    obs["new_pages"] = list(vm.seq(0).pages)
    obs["pool"] = side.np(side.pool)
    obs["restored"] = side.stats()
    obs["after"] = (cs.can_restore(0), cs.swapped_out)
    vm.check_invariants()
    return obs


def port_oom_moves_nothing(side: Side) -> None:
    """The port's restore into too few frames raises OutOfPagesError with
    the pool, the record, the VM and the stats untouched."""
    before = (side.pool.clone(), side.stats(), side.vm.num_seqs,
              side.vm.pool.num_free)
    with pytest.raises(tcore.OutOfPagesError):
        side.cs.restore(0, side.pool)
    assert torch.equal(side.pool, before[0])
    assert (side.stats(), side.vm.num_seqs, side.vm.pool.num_free) == \
        before[1:]
    assert side.cs.swapped_out == [0]


def jax_oom(side: Side) -> None:
    with pytest.raises(jcore.OutOfPagesError):
        side.cs.restore(0, side.pool)
    assert side.cs.swapped_out == [0]


def assert_same_switch(j: dict, t: dict, tol: float) -> None:
    for k in ("old_pages", "new_pages", "spilled", "restored", "no_frames",
              "no_slot", "ready", "extra", "after"):
        assert t[k] == j[k], k
    assert t["old_pages"] != t["new_pages"]          # re-framed
    assert t["no_frames"] is False and t["no_slot"][0] is False
    assert t["no_slot"][1] >= 3 and t["ready"] is True
    for k in ("spilled", "restored"):                # JAX counts no pages
        assert t[k]["pages_spilled"] == t[k]["pages_restored"] == 0
    assert t["spilled"]["switches"] == 1
    assert t["spilled"]["bytes_spilled"] == t["record"].nbytes
    assert t["restored"]["bytes_restored"] == t["record"].nbytes
    for k in ("record", "pool"):
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        if tol:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(t[k], j[k])


def frames(a: np.ndarray, axis: int, pages) -> np.ndarray:
    return np.take(a, pages, axis=axis)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_whole_pool_switch_page_axis_0(dtype):
    """``tests/test_core_tlb.py``'s ``[P, page, W]`` pool: records and the
    re-framed pool exact, stats field by field."""
    rng = np.random.default_rng(0)
    src = (rng.standard_normal((6, 4, 3)) * 40).astype(dtype)
    j = run_whole_pool(Side(jcore, jnp.asarray(src), 0), jax_oom)
    t = run_whole_pool(Side(tcore, torch.from_numpy(src.copy()), 0),
                       port_oom_moves_nothing)
    assert_same_switch(j, t, 0)
    assert t["record"].dtype == src.dtype
    np.testing.assert_array_equal(t["record"], frames(src, 0, t["old_pages"]))
    np.testing.assert_array_equal(frames(t["pool"], 0, t["new_pages"]),
                                  t["record"])
    others = [p for p in range(6) if p not in t["new_pages"]]
    assert (frames(t["pool"], 0, others) == -1).all()


def prefilled_flat_pool(jm, jp, tm, tp, pages, n_tok: int):
    """Both packages' ``[2L, P, page, Hkv, D]`` pools (P 6, page 4) after
    a prefill of ``n_tok`` seeded tokens into frames ``pages``."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tm.cfg.vocab_size, (1, 12)).astype(np.int32)
    table = np.full((1, 4), -1, np.int32)
    table[0, :len(pages)] = pages
    lens = np.array([n_tok], np.int32)
    js = jm.init_kv_state(1, 6, 4, 4)._replace(page_table=jnp.asarray(table))
    _, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), js)
    ts = tm.init_kv_state(1, 6, 4, 4)._replace(
        page_table=torch.from_numpy(table))
    _, ts = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(lens), ts)
    shape = (-1,) + tuple(ts.k_pools.shape[1:])
    return (jnp.stack([js.k_pools, js.v_pools]).reshape(shape),
            torch.stack([ts.k_pools, ts.v_pools]).reshape(shape))


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_whole_pool_switch_page_axis_1_seed_flat_pool(models, kv):
    """The seed engine's flat pool, written by each package's prefill:
    int8 records byte-identical, f32 within the projections' last bits."""
    jm, jp, tm, tp = models[kv]
    # seq 0's first frames on a fresh VM are 0, 1, 2 in both packages
    jflat, tflat = prefilled_flat_pool(jm, jp, tm, tp, [0, 1, 2], 10)
    assert tflat.dtype == (torch.int8 if kv == "int8" else torch.float32)
    assert tflat.shape[0] == 2 * tm.cfg.num_layers
    before = tflat.clone()
    j = run_whole_pool(Side(jcore, jflat, 1), jax_oom)
    t = run_whole_pool(Side(tcore, tflat, 1), port_oom_moves_nothing)
    assert t["old_pages"] == [0, 1, 2]
    assert_same_switch(j, t, F32_TOL if kv == "native" else 0)
    np.testing.assert_array_equal(
        t["record"], frames(before.numpy(), 1, t["old_pages"]))
    np.testing.assert_array_equal(frames(t["pool"], 1, t["new_pages"]),
                                  t["record"])
    assert (t["record"] != 0).any()


def test_whole_pool_restore_refuses_page_axis_2():
    """Both packages spill along axis 2 but restore only axes 0 and 1;
    the port refuses before anything moves."""
    src = np.arange(2 * 3 * 6 * 4, dtype=np.float32).reshape(2, 3, 6, 4)
    sides = (Side(jcore, jnp.asarray(src), 2),
             Side(tcore, torch.from_numpy(src.copy()), 2))
    records = []
    for s in sides:
        s.vm.map_seq(0, 7)
        s.pool = s.cs.spill(0, s.pool, extra_state="x")
        records.append(s.np(s.cs._swap[0].page_data))
    np.testing.assert_array_equal(records[1], records[0])
    np.testing.assert_array_equal(records[1], src[:, :, :2])
    for s in sides:
        with pytest.raises(NotImplementedError, match="page_axis=2"):
            s.cs.restore(0, s.pool)
    port = sides[1]
    assert port.cs.swapped_out == [0] and not port.vm.has_seq(0)
    assert port.stats() == sides[0].stats()


# ---------------------------------------------------------------------------
# the seed engine
# ---------------------------------------------------------------------------


def mixed_workload(vocab):
    rng = np.random.default_rng(13)
    return None, [(i, rng.integers(0, vocab, size=int(rng.integers(4, 14)))
                   .astype(np.int32), 12, False) for i in range(7)]


def fork_workload(vocab, seed, prefix_len, lens, max_new):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=prefix_len).astype(np.int32)
    return prefix, [(i, rng.integers(0, vocab, size=int(n)).astype(np.int32),
                     max_new, True) for i, n in enumerate(lens)]


#: ``tests/test_serve_executor.py``'s workloads and configurations
WORKLOADS = {
    "mixed_preempt": (lambda v: mixed_workload(v),
                      dict(page_size=4, num_pages=16, max_pages_per_seq=16,
                           max_batch=3)),
    "forked_prefix": (lambda v: fork_workload(v, 17, 22, (3, 6, 9), 8),
                      dict(page_size=4, num_pages=64, max_pages_per_seq=32,
                           max_batch=4)),
    "same_step_forks": (lambda v: fork_workload(v, 23, 13, (1, 7, 12), 6),
                        dict(page_size=8, num_pages=64, max_pages_per_seq=16,
                             max_batch=4)),
}


def serve(engine_cls, model, params, scfg, workload, lower=None):
    """Serve ``(prefix, requests)`` to the end; returns the engine and the
    tokens of each request."""
    prefix, reqs = workload
    eng = engine_cls(model, params, scfg)
    if prefix is not None:
        eng.preload_prefix(prefix.copy())
    for i, prompt, max_new, share in reqs:
        req = dict(req_id=i, prompt=prompt.copy(), max_new_tokens=max_new,
                   share_prefix=share)
        eng.submit(lower(req) if lower else ServeRequest(**req))
    done = eng.run()
    if hasattr(eng, "close"):
        eng.close()
    return eng, {i: [int(x) for x in r.output] for i, r in done.items()}


def seed_runs(models, name, kv="native", **overrides):
    """The workload through JAX's seed engine and the port's."""
    jm, jp, tm, tp = models[kv]
    make, kw = WORKLOADS[name]
    wl = make(tm.cfg.vocab_size)
    je, jdone = serve(JaxReferenceEngine, jm, jp,
                      JaxServeConfig(**kw, **overrides), wl,
                      lambda r: jax_to_internal(JaxServeRequest(**r)))
    te, tdone = serve(ReferenceEngine, tm, tp, ServeConfig(**kw, **overrides),
                      wl, lambda r: to_internal(ServeRequest(**r)))
    return wl, (je, jdone), (te, tdone)


def events(eng):
    return [(s.event, s.payload) for s in eng.counters.events()]


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_seed_engine_matches_jax_seed_engine(models, name):
    wl, (je, jdone), (te, tdone) = seed_runs(models, name)
    assert len(tdone) == len(jdone) == len(wl[1])
    for i in jdone:
        assert tdone[i] == jdone[i], f"req {i} diverged from the JAX seed"
    assert te.counters.report()["counters"] == je.counters.report()["counters"]
    ts, js = te.stats(), je.stats()
    assert ts["switch_stats"] == js["switch_stats"]
    assert ts["pool"] == js["pool"]
    assert ts["modeled_ctx_switch_seconds"] == js["modeled_ctx_switch_seconds"]
    assert events(te) == events(je)
    if name == "mixed_preempt":
        assert te.counters.get("preemptions") > 0
        assert te.counters.get("restores") > 0
        assert ts["switch_stats"]["bytes_spilled"] > 0
    else:
        assert te.counters.get("forked_admissions") == len(wl[1])
    te.vmem.check_invariants()


def test_seed_engine_int8_pools_match_jax_seed_engine(models):
    """int8 pools through the whole-pool spill and restore: the narrow
    bytes move, tokens and every counter equal JAX's."""
    wl, (je, jdone), (te, tdone) = seed_runs(models, "mixed_preempt", "int8")
    assert tdone == jdone
    assert te.counters.report()["counters"] == je.counters.report()["counters"]
    assert te.stats()["switch_stats"] == je.stats()["switch_stats"]
    assert te.kv.k_pools.dtype == torch.int8
    assert te.counters.get("preemptions") > 0


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_split_engine_matches_seed_engine(models, name):
    """``TestSeedEquivalence`` / ``TestBatchedForkAdmission`` on the port:
    the split engine (default policy) gives the seed's greedy tokens and
    policy counters; forks run as continuation prefill there."""
    _, _, tm, tp = models["native"]
    make, kw = WORKLOADS[name]
    wl = make(tm.cfg.vocab_size)
    ne, ndone = serve(Engine, tm, tp, ServeConfig(**kw), wl)
    re_, rdone = serve(ReferenceEngine, tm, tp, ServeConfig(**kw), wl,
                       lambda r: to_internal(ServeRequest(**r)))
    assert len(ndone) == len(rdone) == len(wl[1])
    for i in rdone:
        assert ndone[i] == rdone[i], f"req {i} diverged from the seed engine"
    if name == "mixed_preempt":
        assert ne.counters.get("preemptions") > 0
        for c in ("preemptions", "restores", "page_faults", "completed"):
            assert ne.counters.get(c) == re_.counters.get(c), c
    else:
        chunks = sum(len(p) for _, p, _, _ in wl[1])
        assert ne.counters.get("forked_admissions") == 3
        assert ne.counters.get("continuation_prefill_tokens") == chunks
        if name == "same_step_forks":
            assert ne.counters.get("fork_batches") == 1
        assert re_.counters.get("forked_admissions") == 3
    ne.vmem.check_invariants()


def test_seed_temperature_stream_is_reproducible(models):
    """Temperature sampling draws from a generator seeded by
    ``cfg.seed``: one seed, one stream (``jax.random``'s stream cannot be
    reproduced, so the contract is determinism, not JAX's tokens)."""
    _, _, tm, tp = models["native"]
    make, kw = WORKLOADS["mixed_preempt"]
    wl = make(tm.cfg.vocab_size)
    outs = []
    for seed in (7, 7, 8):
        scfg = ServeConfig(**kw, greedy=False, temperature=0.9, seed=seed)
        eng, done = serve(ReferenceEngine, tm, tp, scfg, wl,
                          lambda r: to_internal(ServeRequest(**r)))
        outs.append(done)
        assert all(len(t) == 12 for t in done.values())
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]
    greedy = serve(ReferenceEngine, tm, tp, ServeConfig(**kw), wl,
                   lambda r: to_internal(ServeRequest(**r)))[1]
    assert outs[0] != greedy


def test_seed_engine_keeps_every_tensor_on_the_model_device(models,
                                                            monkeypatch):
    """A CPU model's engine: the pools, every page table, length and token
    tensor handed to the model live on the CPU, and no call leaves the
    device to ``resolve_device``'s default (the card)."""
    _, _, tm, tp = models["native"]

    def no_default(device=None):
        assert device is not None, "a device_page_table call without device"
        return torch.device(device)
    monkeypatch.setattr(tvmem, "resolve_device", no_default)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    model = copy.copy(tm)
    cls = type(tm)

    def spy(name):
        def call(params, tokens, *args):
            state = args[-1]
            seen.append((name, {tokens.device, state.k_pools.device,
                                state.v_pools.device,
                                state.page_table.device,
                                state.seq_lens.device, *(
                                    a.device for a in args[:-1])}))
            return getattr(cls, name)(model, params, tokens, *args)
        return call
    model.prefill = spy("prefill")
    model.decode_step = spy("decode_step")
    for name in ("mixed_preempt", "forked_prefix"):
        make, kw = WORKLOADS[name]
        eng, _ = serve(ReferenceEngine, model, tp, ServeConfig(**kw),
                       make(tm.cfg.vocab_size),
                       lambda r: to_internal(ServeRequest(**r)))
        assert eng.device == torch.device("cpu")
        assert eng._gen.device == torch.device("cpu")
        assert eng.kv.k_pools.device == eng.kv.v_pools.device == eng.device
    assert {n for n, _ in seen} == {"prefill", "decode_step"}
    assert all(devs == {torch.device("cpu")} for _, devs in seen)
