"""The slice as a whole: the port's Engine against the JAX Engine.

Both engines serve the mixed-preemption workload of
``tests/test_serve_executor.py`` (7 requests, 4-13-token prompts, 12 new
tokens) in a tight pool (page 4, 16 frames, 3 lanes) with the radix prefix
cache and partial restore off — the configuration this slice ports.  The
JAX engine runs its ``use_kernels=False`` reference paths; the port runs
on the CPU (``device="cpu"``), where its kernel wrappers take their plain
versions.  Greedy tokens must be identical per request, and the policy
counters and context-switch byte/page counts equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.configs import get_config
from repro_torch.core import (
    ContextSwitcher,
    VirtualMemory,
    VMemConfig,
    gather_pages,
    logical_to_physical,
)
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import Engine, ServeConfig, ServeRequest

pytestmark = pytest.mark.torch_port

COUNTERS = ("preemptions", "restores", "page_faults", "completed",
            "host_syncs", "decode_dispatches", "decode_horizon", "ptab_syncs",
            "ptab_rows_uploaded")
PORTED = dict(page_size=4, num_pages=16, max_pages_per_seq=16, max_batch=3,
              prefix_cache=False, restore_patience=0)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen2-7b", reduced=True)
    jm = jax_build_model(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    cfg = get_config("qwen2-7b", reduced=True)
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_jax(np_params, cfg, "cpu")


def mixed_workload(vocab, n=7, seed=13, max_new=12):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(4, 14)))
             .astype(np.int32), max_new) for i in range(n)]


def run(engine_cls, request_cls, model, params, serve_cfg, workload):
    eng = engine_cls(model, params, serve_cfg)
    for i, prompt, max_new in workload:
        eng.submit(request_cls(req_id=i, prompt=prompt.copy(),
                               max_new_tokens=max_new))
    done = eng.run()
    eng.close()
    return eng, {i: [int(x) for x in r.output] for i, r in done.items()}


@pytest.mark.parametrize("max_horizon,kv_dtype",
                         [(1, "native"), (8, "native"), (8, "int8")])
def test_engine_matches_jax_engine(models, max_horizon, kv_dtype):
    jm, jp, tm, tp = models
    kw = dict(PORTED, max_horizon=max_horizon, kv_dtype=kv_dtype)
    wl = mixed_workload(tm.cfg.vocab_size)
    je, jdone = run(JaxEngine, JaxServeRequest, jm, jp, JaxServeConfig(**kw),
                    wl)
    te, tdone = run(Engine, ServeRequest, tm, tp, ServeConfig(**kw), wl)
    assert te.counters.get("preemptions") > 0
    assert te.counters.get("continuation_prefill_tokens") == 0
    for c in COUNTERS:
        assert te.counters.get(c) == je.counters.get(c), c
    assert dataclasses.asdict(te.switcher.stats) == \
        dataclasses.asdict(je.executor.switcher.stats)
    assert len(tdone) == len(jdone) == len(wl)
    for i in jdone:
        assert tdone[i] == jdone[i], f"req {i} diverged from the JAX engine"
    te.vmem.check_invariants()
    assert te.counters.get("ref_path_dispatches") == 0


def test_plain_path_hatch_is_counted(models):
    """``use_ref_path`` (``--no-kernels``) routes every compute step to the
    plain versions on purpose and counts it; tokens do not change."""
    _, _, tm, tp = models
    wl = mixed_workload(tm.cfg.vocab_size, n=3)
    e0, base = run(Engine, ServeRequest, tm, tp, ServeConfig(**PORTED), wl)
    e1, hatch = run(Engine, ServeRequest, tm, tp,
                    ServeConfig(**PORTED, use_ref_path=True), wl)
    assert hatch == base
    assert e0.counters.get("ref_path_dispatches") == 0
    assert e1.counters.get("ref_path_dispatches") == \
        e0.counters.get("kernel_dispatches") > 0
    assert e1.counters.get("kernel_dispatches") == 0
    assert e1.executor._step_model.use_kernels is False


def test_temperature_stream_fused_equals_stepwise(models):
    """The fused horizon draws from the executor's generator once per inner
    step, exactly as the host sampling path does, so stochastic outputs of
    a K=8 run match a K=1 run (the contract ``tests/test_decode_horizon.py``
    holds for the JAX engine; ``jax.random`` streams themselves cannot be
    reproduced in torch)."""
    _, _, tm, tp = models
    wl = [(i, np.arange(n, dtype=np.int32) % 97 + i, 12)
          for i, n in enumerate((5, 9, 7))]
    outs = {}
    for mh in (1, 8):
        cfg = ServeConfig(page_size=4, num_pages=64, max_pages_per_seq=32,
                          max_batch=3, max_horizon=mh, greedy=False,
                          temperature=0.8, seed=3, prefix_cache=False,
                          restore_patience=0)
        _, outs[mh] = run(Engine, ServeRequest, tm, tp, cfg, wl)
    assert outs[1] == outs[8]
    greedy = ServeConfig(page_size=4, num_pages=64, max_pages_per_seq=32,
                         max_batch=3, prefix_cache=False, restore_patience=0)
    _, g = run(Engine, ServeRequest, tm, tp, greedy, wl)
    assert g != outs[1]            # the sampler really sampled


@pytest.mark.parametrize("override,match", [
    (dict(aot_buckets=(16,)), "aot_buckets"),
    (dict(serve_mesh="auto"), "serve_mesh"),
])
def test_engine_refuses_unported_paths(models, override, match):
    """Both configs are ported now.  AOT buckets build, with a prefill and
    a continuation program for the bucket
    (``tests/test_torch_aot_buckets.py``); the serve mesh is resolved from
    the config (``tests/test_torch_serve_mesh.py``), and with no process
    group started that raises ``launch.mesh``'s ``RuntimeError``, which
    names ``init_process_group``."""
    _, _, tm, tp = models
    cfg = ServeConfig(**{**PORTED, **override})
    if match == "aot_buckets":
        eng = Engine(tm, tp, cfg)
        assert sorted(eng.executor._aot) == [("continue", 16),
                                             ("prefill", 16)]
        eng.close()
        return
    with pytest.raises(RuntimeError, match="init_process_group"):
        Engine(tm, tp, cfg)


def test_forked_requests_are_refused(models):
    """Forked requests are served (``tests/test_torch_continuation.py``),
    and the executor's swap records are portable: a spilled request's
    record exported from one engine detaches there, imports into another
    and restores its bytes into that engine's pools; a second import of the
    same sequence and a record with the wrong page count raise before
    anything moves."""
    _, _, tm, tp = models
    eng = Engine(tm, tp, ServeConfig(**PORTED))
    eng.preload_prefix(np.arange(6, dtype=np.int32))
    eng.submit(ServeRequest(prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=2, share_prefix=True))
    assert eng.run()[0].status == "done"
    eng.submit(ServeRequest(req_id=1, prompt=np.arange(9, dtype=np.int32),
                            max_new_tokens=4))
    eng.step()
    req = eng.running[1]
    eng.scheduler.spill(req)
    assert eng.switcher.swapped_out == [1]
    record = eng.executor.export_swap(req)
    assert eng.switcher.swapped_out == []          # detached at the source
    assert record.page_data.device.type == "cpu"
    assert record.page_data.dtype == eng.kv.k_pools.dtype
    assert record.page_data.shape[2] == 3          # 10 tokens, page 4

    dest = Engine(tm, tp, ServeConfig(**PORTED))
    dest.executor.import_swap(req, record)
    assert dest.switcher.swapped_out == [1]
    free = dest.vmem.pool.num_free
    with pytest.raises(ValueError, match="already spilled"):
        dest.executor.import_swap(req, record)
    short = dataclasses.replace(record, seq_id=2,
                                page_data=record.page_data[:, :, :2])
    with pytest.raises(ValueError, match="carries 2 pages"):
        dest.executor.import_swap(req, short)
    assert dest.switcher.swapped_out == [1]
    assert dest.vmem.pool.num_free == free          # nothing moved
    dest.executor.restore(req, record.num_tokens)
    frames = dest.vmem.seq(1).pages
    assert torch.equal(dest.kv.k_pools[:, frames], record.page_data[0])
    assert torch.equal(dest.kv.v_pools[:, frames], record.page_data[1])
    assert dest.switcher.swapped_out == []
    dest.vmem.check_invariants()
    eng.close()
    dest.close()


def test_drain_returns_typed_results_with_timings(models):
    _, _, tm, tp = models
    eng = Engine(tm, tp, ServeConfig(**PORTED))
    streamed = []
    for i, prompt, _ in mixed_workload(tm.cfg.vocab_size, n=3):
        eng.submit(ServeRequest(prompt=prompt, max_new_tokens=4,
                                stream_callback=streamed.append))
    res = eng.drain()
    eng.close()
    assert sorted(res) == [0, 1, 2]
    for r in res.values():
        assert r.status == "done" and len(r.tokens) == 4
        assert r.ttft > 0 and r.tpot >= 0
    assert len(streamed) == 12


class TestContextSwitch:
    def test_spill_restore_round_trip_is_bit_exact(self):
        """Whole-sequence spill/restore over [L, P, page, Hkv, hd] pools:
        only the victim's pages move, to new frames, bit for bit, in the
        pool's dtype (bf16 stays bf16 in the host record)."""
        vm = VirtualMemory(VMemConfig(page_size=4, num_pages=10,
                                      max_pages_per_seq=4, max_seqs=3))
        sw = ContextSwitcher(vm)
        gen = torch.Generator().manual_seed(0)
        k = torch.randn((2, 10, 4, 2, 3), generator=gen).to(torch.bfloat16)
        v = torch.randn((2, 10, 4, 2, 3), generator=gen).to(torch.bfloat16)
        vm.map_seq(7, 4)                   # occupies the first frame
        st = vm.map_seq(1, 10)
        before_k = k[:, st.pages].clone()
        before_v = v[:, st.pages].clone()
        sw.spill_kv(1, k, v)
        assert sw.spilled_len(1) == 10
        rec = sw._swap[1].page_data
        assert rec.device.type == "cpu" and rec.dtype == torch.bfloat16
        page_bytes = 2 * 4 * 2 * 3 * 2          # L x page x Hkv x hd x 2 B
        assert sw.stats.bytes_spilled == 2 * 3 * page_bytes
        assert sw.stats.pages_spilled == 6
        vm.map_seq(8, 8)                   # the freed frames get reused
        k2, v2, _ = sw.restore_kv(1, k, v)
        assert k2 is k and v2 is v          # restored in place
        new = vm.seq(1).pages
        torch.testing.assert_close(k[:, new], before_k, atol=0, rtol=0)
        torch.testing.assert_close(v[:, new], before_v, atol=0, rtol=0)
        assert sw.stats.bytes_restored == sw.stats.bytes_spilled
        assert sw.stats.pages_restored == 6
        sw.discard(1)
        vm.check_invariants()

    def test_device_page_table_and_translation_helpers(self):
        vm = VirtualMemory(VMemConfig(page_size=4, num_pages=8,
                                      max_pages_per_seq=4, max_seqs=2))
        vm.map_seq(9, 3)
        vm.map_seq(0, 6)
        pt = vm.device_page_table("cpu")
        assert pt.dtype == torch.int32 and pt.shape == (2, 4)
        slot = vm.seq(0).slot
        assert pt[slot, :2].tolist() == vm.seq(0).pages
        assert vm.device_seq_lens("cpu")[slot] == 6
        pos = np.arange(6)
        rows = logical_to_physical(torch.as_tensor(pos), pt[slot], 4)
        np.testing.assert_array_equal(rows.numpy(), vm.translate(0, pos))
        pool = torch.arange(8 * 4).reshape(8, 4)
        got = gather_pages(pool, pt[slot], 2)
        np.testing.assert_array_equal(got.numpy(),
                                      pool.numpy()[vm.seq(0).pages])
