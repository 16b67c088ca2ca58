"""The port's serve executor on the mesh: ``Engine(mesh=...)`` on gloo ranks.

The counterpart of every class of ``tests/test_serve_sharded.py``.  One
module fixture starts, all at once, each as its own process:
  * 4 gloo ranks of ``tests/torch_serve_mesh_worker.py`` (file rendezvous
    in ``tmp_path``): the reduced qwen2-7b (Hkv 2, hd 14) served through
    the port's ``Engine`` on ``make_host_serve_mesh``, a (kv 2, hd 2) mesh,
    for every scenario of ``torch_serve_mesh_worker.SCENARIOS``;
  * ``tests/jax_serve_mesh_reference.py`` under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``: JAX's
    ``Engine`` on JAX's (kv 2, hd 2) serve mesh and on one device, for the
    scenarios JAX's fixture model serves (``use_kernels=False``);
  * 4 ranks of the launcher, ``python -m repro_torch.launch.serve
    --serve-mesh 4 --dist-init file://...``, which starts its own group.
Meanwhile this process serves every scenario through the port's engine on
one device, and the launcher with ``--serve-mesh off``.  All share one
deadline; on it every process is killed and the fixture fails, so a
diverged rank (a hung collective) fails these tests instead of stalling
the suite.

The workloads are ``test_serve_sharded.py``'s, made from the same seeds
with numpy, and the weights JAX's ``init`` from ``PRNGKey(0)``, carried
over by ``params_from_jax``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import torch_serve_mesh_worker as W
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import Engine, ServeConfig, ServeRequest

pytestmark = pytest.mark.torch_port

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
RANKS = 4
#: seconds every process of the fixture may take, all together: a
#: hang guard, well past what a loaded run of the whole suite takes
DEADLINE_S = 600
#: the counters ``test_serve_sharded.py`` holds equal, and the fork ones
COUNTERS = ("decode_tokens", "decode_dispatches", "decode_horizon",
            "host_syncs", "ptab_syncs", "page_faults", "preemptions",
            "restores", "fork_batches", "forked_admissions")
#: the f32 KV bound of ROADMAP Queue 3 (the port's pools against JAX's)
F32_POOL_TOL = 2.1e-6
#: the launcher's output lines held equal on and off the mesh
LAUNCH_LINES = ("tokens ", "completed ", "router: ", "router counters:",
                "router global pages:", "scheduler (policy plane)",
                "executor (data plane)", "  page-table delta", "  kernel "
                "dispatch", "  kv pools", "  fused decode", "  continuation",
                "pool:")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _start(cmd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=f"{SRC}{os.pathsep}{HERE}", OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _launch(argv) -> str:
    """The launcher in this process; its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launcher.main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_mesh")
    jm = jax_build_model(jax_get_config("qwen2-7b", reduced=True),
                         remat=False)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jm.init(jax.random.PRNGKey(0)))
    np.savez(work / "weights.npz", **_flatten(np_params))
    t0 = time.monotonic()
    procs = {"jax": _start(
        [sys.executable, str(HERE / "jax_serve_mesh_reference.py"),
         str(work)],
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
         "JAX_PLATFORMS": "cpu"})}
    for r in range(RANKS):
        procs[f"rank{r}"] = _start(
            [sys.executable, str(HERE / "torch_serve_mesh_worker.py"),
             str(r), str(RANKS), str(work / "store"), str(work)])
    for r in range(RANKS):
        procs[f"launcher{r}"] = _start(
            [sys.executable, "-m", "repro_torch.launch.serve", *W.LAUNCH,
             "--serve-mesh", str(RANKS), "--dist-init",
             f"file://{work / 'launcher_store'}"],
            {"RANK": str(r), "WORLD_SIZE": str(RANKS)})
    outs = {}
    try:
        # this process's share, while the ranks run: one device
        cfg = get_config("qwen2-7b", reduced=True)
        params = params_from_jax(np_params, cfg, "cpu")
        model = build_model(cfg, device="cpu")
        single, arrays = {}, {}
        for name in W.SCENARIOS:
            eng, tokens, records = W.scenario_run(
                name, Engine, ServeRequest, ServeConfig, model, params,
                cfg.vocab_size)
            single[name] = W.summary(eng, tokens)
            if name in W.KEEP_STATE:
                arrays[name] = dict(k_pools=eng.kv.k_pools.numpy(),
                                    v_pools=eng.kv.v_pools.numpy(),
                                    records=records)
            eng.close()
        plain = build_model(cfg, device="cpu", use_kernels=False)
        sc = W.SCENARIOS["kernels"]
        _, plain_tokens, _ = W.run_engine(
            Engine, ServeRequest, plain, params, ServeConfig(**sc["serve"]),
            W.workload(cfg.vocab_size, **sc["work"]))
        off = {"plain": _launch(W.LAUNCH),
               "replicas": _launch(W.LAUNCH + ["--replicas", "2"])}
        for name, p in procs.items():
            left = DEADLINE_S - (time.monotonic() - t0)
            try:
                outs[name], err = p.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{name} did not finish in {DEADLINE_S} s")
            if p.returncode != 0:
                pytest.fail(f"{name} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(
        ranks=[json.loads((work / f"rank{r}.json").read_text())
               for r in range(RANKS)],
        rank_arrays=[dict(np.load(work / f"rank{r}.npz"))
                     for r in range(RANKS)],
        jax=json.loads((work / "jax_serve.json").read_text()),
        single=single, single_arrays=arrays, plain_tokens=plain_tokens,
        off=off, launcher=[outs[f"launcher{r}"] for r in range(RANKS)],
        cfg=cfg, seconds=time.monotonic() - t0)


def _runs(runs, name):
    return [res["runs"][name] for res in runs["ranks"]]


def _same_schedule(got, want, who):
    assert got["tokens"] == want["tokens"], who
    for c in COUNTERS:
        assert got["counters"].get(c, 0) == want["counters"].get(c, 0), \
            (who, c)
    for k in ("switches", "pages_spilled", "pages_restored",
              "bytes_spilled", "bytes_restored"):
        assert got["switch"][k] == want["switch"][k], (who, k)


def _identity(runs, name):
    """Every rank against the port's single-process engine and, where JAX
    served the scenario, JAX's mesh and single-device engines."""
    refs = {"port single": runs["single"][name]}
    if W.SCENARIOS[name].get("jax"):
        for where in ("mesh", "single"):
            refs[f"jax {where}"] = runs["jax"]["runs"][f"{name}/{where}"]
    for r, got in enumerate(_runs(runs, name)):
        for who, want in refs.items():
            _same_schedule(got, want, f"rank {r} vs {who}")
            assert got["is_dtensor"] == "DTensor"
    return _runs(runs, name)


# ---------------------------------------------------------------------------
# TestMeshFactorization
# ---------------------------------------------------------------------------


def test_axes_divide_model_dims(runs):
    cfg = runs["cfg"]
    for r, res in enumerate(runs["ranks"]):
        assert res["mesh_axes"] == ["kv", "hd"]
        kv, hd = res["mesh_shape"]
        assert cfg.num_kv_heads % kv == 0 and cfg.head_dim % hd == 0
        assert 1 < kv * hd <= RANKS
        assert res["coord"] == [r // hd, r % hd]
    assert runs["jax"]["mesh_shape"] == runs["ranks"][0]["mesh_shape"]
    assert runs["jax"]["mesh_axes"] == ["kv", "hd"]
    assert runs["seconds"] < DEADLINE_S


def test_degrades_to_single_device(runs):
    """``make_host_serve_mesh(1, 1)`` has one rank; an engine on it is the
    meshless engine: plain pools, the same tokens, counters and stats."""
    ranks = runs["ranks"]
    assert all(res["one_size"] == 1 for res in ranks)
    one = ranks[0]["one"]
    assert one["is_dtensor"] == "Tensor"
    want = runs["single"]["k4"]
    assert one["tokens"] == want["tokens"]
    assert one["counters"] == want["counters"]
    assert one["switch"] == want["switch"]


def test_rank_outside_the_mesh_is_refused(runs):
    """Ranks 1-3 are not in the one-rank mesh: building an engine on it
    raises the model's ``ValueError`` there."""
    assert [res["one"] for res in runs["ranks"][1:]] == ["ValueError"] * 3


# ---------------------------------------------------------------------------
# TestTokenIdentity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["k1", "k4"])
def test_greedy_identity_forced_horizons(runs, name):
    for got in _identity(runs, name):
        if name == "k4":
            c = got["counters"]
            assert c["decode_dispatches"] < c["decode_horizon"]


def test_temperature_stream_identity(runs):
    """Every rank draws from a generator seeded from ``cfg.seed`` over the
    same replicated logits: each rank's stream is the single-process
    port's (``jax.random`` streams cannot be matched)."""
    want = runs["single"]["temperature"]
    for r, got in enumerate(_runs(runs, "temperature")):
        _same_schedule(got, want, f"rank {r}")
    assert want["tokens"] != runs["single"]["kernels"]["tokens"]


# ---------------------------------------------------------------------------
# TestSpillRestoreSharded
# ---------------------------------------------------------------------------


def test_preempting_workload_identity(runs):
    for got in _identity(runs, "preempt"):
        assert got["counters"]["preemptions"] > 0
        assert got["switch"]["bytes_spilled"] > 0
        assert got["switch"]["bytes_restored"] > 0


def test_forked_prefix_workload_identity(runs):
    for got in _identity(runs, "fork"):
        assert got["counters"]["forked_admissions"] > 0


@pytest.mark.parametrize("name", W.KEEP_STATE)
def test_swap_records_identical_to_single_process(runs, name):
    """Every rank keeps the whole record of each spill, byte for byte the
    single-process engine's (the stats and record portability follow)."""
    want = runs["single_arrays"][name]["records"]
    assert want
    for r, arrays in enumerate(runs["rank_arrays"]):
        got = [arrays[f"{name}/record{i}"] for i in range(len(want))]
        assert f"{name}/record{len(want)}" not in arrays
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), f"rank {r}"


# ---------------------------------------------------------------------------
# TestShardedKernelDispatch
# ---------------------------------------------------------------------------


def test_kernels_stay_live_on_mesh(runs):
    single = runs["single"]["kernels"]
    for r, got in enumerate(_identity(runs, "kernels")):
        assert got["step_is_twin"] and got["step_use_kernels"]
        assert got["step_mesh_is_mesh"] and got["model_mesh_none"]
        assert got["counters"].get("ref_path_dispatches", 0) == 0
        assert got["counters"]["kernel_dispatches"] > 0
        assert (got["counters"]["kernel_dispatches"]
                == single["counters"]["kernel_dispatches"])
        assert got["replays"] == 0, f"rank {r}: a graph on the mesh"


def test_explicit_ref_path_escape_hatch(runs):
    for got in _runs(runs, "ref_path"):
        assert got["step_use_kernels"] is False and got["step_mesh_is_mesh"]
        assert got["counters"]["ref_path_dispatches"] > 0
        assert got["counters"].get("kernel_dispatches", 0) == 0
        assert got["tokens"] == {str(k): v for k, v in
                                 runs["plain_tokens"].items()}


def test_kernel_path_spill_restore_sharded(runs):
    cfg = runs["cfg"]
    sc = W.SCENARIOS["preempt"]["serve"]
    page_bytes = (cfg.num_layers * sc["page_size"] * cfg.num_kv_heads
                  * cfg.head_dim * 4)
    for got in _identity(runs, "preempt"):
        assert got["counters"]["preemptions"] > 0
        assert got["counters"].get("ref_path_dispatches", 0) == 0
        st = got["switch"]
        assert st["bytes_spilled"] == st["pages_spilled"] * page_bytes


# ---------------------------------------------------------------------------
# int8 pools and AOT buckets on the mesh
# ---------------------------------------------------------------------------


def test_int8_pools_preempting(runs):
    for got in _identity(runs, "preempt_int8"):
        c = got["counters"]
        assert c["preemptions"] > 0
        assert c["quant_dispatches"] == runs["single"]["preempt_int8"][
            "counters"]["quant_dispatches"] > 0


def test_aot_buckets_preempting(runs):
    want = runs["single"]["preempt_aot"]["counters"]
    assert want["aot_hits"] > 0 and want["preemptions"] > 0
    for got in _identity(runs, "preempt_aot"):
        for c in ("aot_hits", "aot_misses", "bucket_pad_tokens"):
            assert got["counters"].get(c, 0) == want.get(c, 0), c


# ---------------------------------------------------------------------------
# the end state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", W.KEEP_STATE)
def test_final_pool_slices(runs, name):
    """Each rank's [L, P, page, 1, 7] slices against the same slice of the
    single-process pools: int8 bit for bit, f32 within Queue 3's bound."""
    single = runs["single_arrays"][name]
    for r, (res, arrays) in enumerate(zip(runs["ranks"],
                                          runs["rank_arrays"])):
        kv, hd = res["coord"]
        for key in ("k_pools", "v_pools"):
            want = single[key][:, :, :, kv:kv + 1, hd * 7:(hd + 1) * 7]
            got = arrays[f"{name}/{key}"]
            assert got.shape == want.shape
            if name.endswith("int8"):
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"rank {r} {key}")
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=F32_POOL_TOL,
                                           err_msg=f"rank {r} {key}")


def test_check_sharding_invariants(runs):
    """After the preempting run every rank's state has its declared layout
    (pools split on dims 3 and 4 to [2, 16, 4, 1, 7]); a replicated pool,
    a pool moved to new storage, a DTensor page table and a split logits
    tensor each raise ``RuntimeError``, and the check passes again once the
    state is put back."""
    for res in runs["ranks"]:
        lay = res["layout"]
        assert lay["pool_layout"] == [[3, 4]]
        assert lay["local_shape"] == [2, 16, 4, 1, 7]
        assert lay["global_shape"] == [2, 16, 4, 2, 14]
        assert lay["clean"] == lay["after"] == "none"
        for drift in ("replicated_pool", "moved_pool", "dtensor_page_table",
                      "split_logits"):
            assert lay[drift] == "RuntimeError", drift


def test_check_sharding_invariants_without_a_mesh_checks_nothing(runs):
    cfg = runs["cfg"]
    model = build_model(cfg, device="cpu")
    eng = Engine(model, model.init(0), ServeConfig(page_size=4,
                                                   num_pages=8))
    eng.executor.check_sharding_invariants(
        extra=(("logits", torch.zeros(2, 3)),))
    assert eng.executor.mesh is None and eng.executor._layout is None
    eng.close()


# ---------------------------------------------------------------------------
# the config, the launcher and the router on the mesh
# ---------------------------------------------------------------------------


def test_build_mesh_resolves_or_names_the_missing_group(runs):
    cfg = runs["cfg"]
    assert ServeConfig().build_mesh(cfg) is None
    for spec in ("auto", "4"):
        sc = ServeConfig(serve_mesh=spec)
        assert "no CUDA graphs" in sc.describe()
        with pytest.raises(RuntimeError, match="init_process_group"):
            sc.build_mesh(cfg, device="cpu")


def _lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(LAUNCH_LINES)
            and not ln.startswith("completed ")] + [
        ln.split(" tokens in ")[0] for ln in out.splitlines()
        if ln.startswith("completed ")]


@pytest.mark.parametrize("kind", ["plain", "replicas"])
def test_launcher_on_the_mesh_equals_off(runs, kind):
    """Rank 0's tokens and counter summary on 4 ranks (``--serve-mesh 4``;
    the plain launcher started its own group through ``--dist-init
    file://``, the router over two mesh engines ran on the workers'
    group) equal the ``--serve-mesh off`` run of the same arguments; only
    rank 0 prints."""
    if kind == "plain":
        mesh_out = runs["launcher"][0]
        assert all(out == "" for out in runs["launcher"][1:])
    else:
        mesh_out = runs["ranks"][0]["launcher_replicas"]
        assert "replica router: 2 replicas" in mesh_out
    assert "serve mesh: {'kv': 2, 'hd': 2} over 4 of 4 ranks" in mesh_out
    got, want = _lines(mesh_out), _lines(runs["off"][kind])
    assert sum(ln.startswith("tokens ") for ln in want) == 4
    assert got == want


def test_launcher_without_a_group_names_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        launcher.main(W.LAUNCH + ["--serve-mesh", "4"])
