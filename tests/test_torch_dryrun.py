"""The dry-run in the port against the JAX package, on the CPU: the case
builders of ``launch/specs.py``, ``launch/dryrun.py``, the op counter
(``launch/op_cost.py``, JAX's ``hlo_cost.py``), the roofline
(``launch/analysis.py``, JAX's ``hlo_analysis.py``) and
``TransformerLM(remat_policy="dots")``.

One module fixture starts, at once, ``tests/torch_dryrun_worker.py`` (the
port's cases as rank 0 of a fake 512-rank group, which must not leak into
this process, then the mesh training step on a fake 8-rank group) and
``tests/jax_dryrun_reference.py`` (JAX's cases on 512 forced host
devices), under one deadline that kills both; the first test starts them
and the tests that need neither run meanwhile.  Every (arch x shape) on
the 16 x 16 mesh is held to JAX's; the 2 x 16 x 16 mesh and the flat
serve view are held on :data:`jax_dryrun_reference.SUBSET`, one arch of
each family, so that the port's side (each case's weights initialised
on ``meta``) keeps this file within its minute.

Tolerances: the case shapes, dtypes, kinds and model FLOPs exactly; the
roofline terms 1e-12 relative; the reduced dense step's matmul FLOPs
exactly against a hand count, its total within 15 % of JAX's
``hlo_cost.analyze``; the collective bytes exactly; the ``"dots"``
gradients within ``1e-4 * max|g| + 1e-7`` of JAX's (the bound of
``tests/test_torch_train.py``) and bit for bit against ``remat=True``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_dryrun_reference as JREF
from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import hlo_analysis, hlo_cost
from repro.models import build_model as jax_build_model
from repro.models.config import SHAPES
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.core import costmodel
from repro_torch.kernels import ref
from repro_torch.launch import analysis, dryrun, op_cost
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import layers as L
from repro_torch.optim import (AdamWConfig, adamw_init, tree_leaves,
                               tree_unflatten)
from repro_torch.train import make_train_step
from test_torch_train_mesh import _start, jax_leaf_of

pytestmark = pytest.mark.torch_port

HERE = pathlib.Path(__file__).resolve().parent
#: seconds both processes of the fixture may take, together: a hang guard
DEADLINE_S = 600
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
#: chip_smoke.py's mesh training step on the card (PERF.md, PR 33): the
#: bytes ``step.comm`` counted a rank and a step
CARD_GATHERED, CARD_REDUCED = 374_800_384, 830_779_392


def _cells():
    """The fixture's cells, as the reference and the worker list them."""
    cells = [(a, s, 0, "2d") for a in ARCHS for s in SHAPES]
    cells += [(a, s, 1, "2d") for a in JREF.SUBSET for s in SHAPES]
    cells += [(a, s, 0, "flat") for a in JREF.SUBSET for s in SHAPES
              if SHAPES[s].kind != "train"]
    return [f"{a}|{s}|{m}|{mode}" for a, s, m, mode in cells
            if not (s == "long_500k"
                    and not jax_get_config(a).sub_quadratic)]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both processes, started (the first test asks for them, so that the
    tests that need no process run while they work); killed at the end
    of the module if still running."""
    work = tmp_path_factory.mktemp("dryrun")
    procs = {
        "port": _start([sys.executable, str(HERE / "torch_dryrun_worker.py"),
                        str(work)]),
        "jax": _start([sys.executable, str(HERE / "jax_dryrun_reference.py"),
                       str(work / "jax.json")],
                      {"XLA_FLAGS": "--xla_force_host_platform_device_count"
                                    "=512", "JAX_PLATFORMS": "cpu"}),
    }
    yield work, procs, time.monotonic()
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def runs(started):
    work, procs, t0 = started
    for name, p in procs.items():
        left = DEADLINE_S - (time.monotonic() - t0)
        try:
            _, err = p.communicate(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{name} did not finish in {DEADLINE_S} s")
        if p.returncode != 0:
            pytest.fail(f"{name} exited {p.returncode}:\n{err[-3000:]}")
    return {"port": json.loads((work / "port.json").read_text()),
            "jax": json.loads((work / "jax.json").read_text()),
            "cells": work / "cells",
            "seconds": time.monotonic() - t0}


def test_processes_start(started):
    assert all(p.pid for p in started[1].values())


# ---------------------------------------------------------------------------
# the op counter and the roofline against JAX's
# ---------------------------------------------------------------------------


SCOPE_NAMES = (
    "jit(step)/transpose(jvp(TransformerLM.forward))/dot_general",
    "TransformerLM._block_apply/attention_train/einsum/bmm",
    "moe_apply_sorted/top_k", "adamw_update/sqrt", "TransformerLM.embed/index",
    "softmax_xent/logsumexp", "paged_decode_attention_sharded/cat",
    "ragged_dot_ref/mm", "rmsnorm/mul", "global_norm/linalg_vector_norm",
    "flash_attention_ref/_softmax", "take_along_axis", "expert_choice",
)


@pytest.mark.parametrize("name", SCOPE_NAMES)
def test_scope_bucket_equals_jax(name):
    assert op_cost.scope_bucket(name) == hlo_cost.scope_bucket(name)


def _jax_on_h100(monkeypatch):
    """JAX's ``hlo_analysis`` with its constants set to the port's H100
    ones."""
    monkeypatch.setattr(hlo_analysis, "TPU_PEAK_FLOPS_BF16",
                        costmodel.H100_PEAK_FLOPS_BF16)
    monkeypatch.setattr(hlo_analysis, "TPU_HBM_BW", costmodel.H100_HBM_BW)
    monkeypatch.setattr(hlo_analysis, "TPU_ICI_BW_PER_LINK",
                        costmodel.H100_NET_BW)


@pytest.mark.parametrize("seed", range(6))
def test_roofline_equals_jax(monkeypatch, seed):
    _jax_on_h100(monkeypatch)
    rng = np.random.default_rng(seed)
    cost = {"flops": float(10 ** rng.uniform(9, 16)),
            "bytes accessed": float(10 ** rng.uniform(8, 13))}
    counts = {"all-gather": int(rng.integers(1, 400)),
              "all-reduce": int(rng.integers(0, 400))}
    by_kind = {k: int(10 ** rng.uniform(6, 11)) for k in counts}
    chips, model = int(rng.choice([256, 512])), float(10 ** rng.uniform(
        12, 18))
    got = analysis.roofline(cost, analysis.CollectiveStats(counts, by_kind),
                            chips=chips, model_flops=model)
    want = hlo_analysis.roofline(
        cost, hlo_analysis.CollectiveStats(counts, by_kind), chips=chips,
        model_flops=model)
    assert got.dominant == want.dominant
    assert got.to_dict().keys() == want.to_dict().keys()
    for k in ("bound_s", "useful_flops_fraction", "roofline_fraction",
              "compute_s", "memory_s", "collective_s"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-12)
    assert analysis.fmt_seconds(got.bound_s) == hlo_analysis.fmt_seconds(
        want.bound_s)


@pytest.mark.parametrize("s", [0.0, float("nan"), 3.2e-9, 4.5e-7, 2.1e-4,
                               0.75, 12.5])
def test_fmt_seconds_equals_jax(s):
    assert analysis.fmt_seconds(s) == hlo_analysis.fmt_seconds(s)


def test_h100_constants():
    """Data-sheet numbers of the H100 SXM5 80GB and the DGX H100's
    network (one NDR 400 Gb/s port a GPU)."""
    assert costmodel.H100_HBM_BYTES == 80e9
    assert costmodel.H100_NET_BW == 400e9 / 8
    assert costmodel.H100_NVLINK_BW == 450e9


def test_op_cost_conventions():
    """A matmul counts 2·M·K·N, an elementwise op prod(out), a view and a
    factory nothing; bytes are operands plus output; a convert of as many
    elements is free; the plain ragged_dot counts as ``ragged_dot``."""
    x, w = torch.randn(8, 16), torch.randn(16, 4)

    def fn(x, w):
        y = x @ w                      # mm: 2*8*16*4 FLOPs
        z = (y + 1.0).view(32)         # add: 32 FLOPs; the view is free
        torch.zeros(5)                 # a factory: free
        return z.to(torch.float64)     # a convert of 32 elements: free
    c, out = op_cost.count(fn, x, w)
    assert c.matmul_flops == 2 * 8 * 16 * 4
    assert c.flops == 2 * 8 * 16 * 4 + 32
    assert c.bytes == (8 * 16 + 16 * 4 + 32) * 4 + (32 + 32) * 4
    assert out.dtype == torch.float64 and not c.coll_counts
    xs = torch.randn(10, 16)
    we = torch.randn(5, 16, 4)
    sizes = torch.tensor([2, 0, 3, 4, 1], dtype=torch.int32)
    c, got = op_cost.count(ref.ragged_dot_ref, xs, we, sizes)
    assert c.flops == c.matmul_flops == 2 * 10 * 16 * 4
    assert c.bytes == (10 * 16 + 5 * 16 * 4 + 10 * 4) * 4 + 5 * 4
    assert torch.equal(got, ref.ragged_dot_ref(xs, we, sizes))


def test_peak_above_skips_an_argument_seen_through_a_view():
    """``MemTracker`` alone counts a storage it first meets through a view
    as an allocation; ``dryrun.peak_above`` tells it of the arguments
    first, so the peak is the f32 copy's alone."""
    w = torch.empty(16, 512, 1024, device="meta", dtype=torch.bfloat16)
    out, peak = dryrun.peak_above((w,), lambda: w[3].float())
    assert out.shape == (512, 1024) and peak == 512 * 1024 * 4
    assert op_cost.tree_bytes({"a": w, "b": [w, w[0]]}) == (
        w.numel() * 2 + 512 * 1024 * 2)


def test_op_cost_scopes_the_backward():
    w = torch.randn(16, 4, requires_grad=True)

    def fn(w):
        loss = L.softmax_xent((torch.ones(2, 3, 16) @ w),
                              torch.zeros(2, 3, dtype=torch.int32))
        return torch.autograd.grad(loss, [w])
    c, _ = op_cost.count(fn, w)
    assert c.flops_by_scope["backward"] > 0 and c.flops_by_scope["loss"] > 0


def _dense_step_inputs():
    arch = "qwen2-7b"
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              param_dtype="float32")
    return jcfg, cfg, JREF._batch(cfg)


def _hand_matmul_flops(cfg, b, s) -> int:
    """The reduced dense step's matmul FLOPs from the config: every
    projection, the attention's two products and the head, each three
    times (forward, and the backward's two products), and each block's
    products once more but its last (``remat=True`` recomputes a block in
    the backward, and the non-reentrant checkpoint stops once the tensors
    the backward saved are rebuilt: no backward needs ``w_down``'s
    output)."""
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    t = b * s
    proj = 2 * t * d * (h * hd + 2 * kv * hd) + 2 * t * h * hd * d
    attn = 2 * (2 * b * h * s * s * hd)
    down = 2 * t * f * d
    block = proj + attn + 3 * down
    head = 2 * t * d * cfg.vocab_size
    return cfg.num_layers * (block * 4 - down) + head * 3


def test_op_cost_dense_step_against_hand_count_and_hlo_cost():
    """The reduced qwen2-7b train step (f32, remat, B 4 x S 64): matmul
    FLOPs equal the hand count; the total within 15 % of JAX's
    ``hlo_cost.analyze`` of the same step compiled on one CPU device."""
    jcfg, cfg, batch = _dense_step_inputs()
    jm = jax_build_model(jcfg, use_kernels=False, remat=True)
    jp = jm.init(jax.random.PRNGKey(0))
    text = jax_make_train_step(jm, JaxAdamWConfig()).lower(
        jp, jax_adamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()}
    ).compile().as_text()
    want = hlo_cost.analyze(text)["flops"]
    model = build_model(cfg, device="cpu", use_kernels=False, remat=True)
    params = model.init(0)
    got, _ = op_cost.count(make_train_step(model, AdamWConfig()), params,
                           adamw_init(params),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.matmul_flops == _hand_matmul_flops(cfg, JREF.RATIO_BATCH,
                                                  JREF.RATIO_SEQ)
    assert abs(got.flops / want - 1) <= 0.15, (got.flops, want)


# ---------------------------------------------------------------------------
# remat_policy="dots"
# ---------------------------------------------------------------------------


def _batch_np(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


def _port_grads(cfg, np_params, bn, **kw):
    model = build_model(cfg, device="cpu", use_kernels=False, **kw)
    params = params_from_jax(np_params, cfg, "cpu")
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in bn.items()})
    return loss, tree_unflatten(params, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_remat_dots_gradients_equal_jax_and_remat(arch):
    jcfg = jax_get_config(arch, reduced=True)
    jm = jax_build_model(jcfg, remat=True, use_kernels=False,
                         remat_policy="dots")
    jp = jm.init(jax.random.PRNGKey(0))
    bn = _batch_np(jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in bn.items()})
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    cfg = get_config(arch, reduced=True)
    loss, grads = _port_grads(cfg, np_params, bn, remat=True,
                              remat_policy="dots")
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg,
                           "cpu")
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        peak = b.abs().max().item()
        assert (a - b).abs().max().item() <= GRAD_RTOL * peak + GRAD_FLOOR
    _, plain = _port_grads(cfg, np_params, bn, remat=True)
    for a, b in zip(tree_leaves(grads), tree_leaves(plain)):
        assert torch.equal(a, b)


def saved_bytes(policy) -> int:
    """The bytes the reduced qwen2-7b's forward keeps for its backward
    (``MemTracker``'s current bytes after the loss, before the backward),
    under ``remat=True`` and ``policy``."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = get_config("qwen2-7b", reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False, remat=True,
                        remat_policy=policy)
    params = model.init(0)
    for x in tree_leaves(params):
        x.requires_grad_(True)
    bn = _batch_np(cfg, b=4, s=64)
    with MemTracker() as mt:
        loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                      for k, v in bn.items()})
        held = sum(v["Total"] for v in
                   mt.get_tracker_snapshot("current").values())
        del loss
    return held


def test_remat_dots_saves_more_than_plain_remat():
    """The matmul outputs stay for the backward: reduced qwen2-7b, B 4 x
    S 64, f32 (the figures in CHANGES.md)."""
    plain, dots = saved_bytes(None), saved_bytes("dots")
    assert dots > plain
    cfg = get_config("qwen2-7b", reduced=True)
    # at least each layer's q, k, v, o, gate, up and down outputs
    t = 4 * 64
    per_layer = t * (cfg.num_heads * cfg.head_dim
                     + 2 * cfg.num_kv_heads * cfg.head_dim + cfg.d_model
                     + 2 * cfg.d_ff + cfg.d_model) * 4
    assert dots - plain >= cfg.num_layers * per_layer * 0.99


@pytest.mark.parametrize("policy", ["everything", "dots_with_no_batch_dims",
                                    ""])
def test_unknown_remat_policy_raises(policy):
    cfg = get_config("qwen2-7b", reduced=True)
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(cfg, device="cpu", use_kernels=False,
                    remat_policy=policy)


def test_remat_policy_on_a_family_without_it_raises():
    """As JAX's: RWKV-6 and RG-LRU take no ``remat_policy``."""
    for arch in ("rwkv6-7b", "recurrentgemma-9b"):
        with pytest.raises(TypeError, match="remat_policy"):
            build_model(get_config(arch, reduced=True), device="cpu",
                        remat_policy="dots")


def test_remat_apply_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="remat policy"):
        L.remat_apply(True, lambda x: x, torch.ones(1), policy="all")
    assert math.isfinite(L.remat_apply(False, lambda x: x * 2,
                                       torch.ones(1)).item())


# ---------------------------------------------------------------------------
# the processes' records
# ---------------------------------------------------------------------------


def test_fixture_within_its_deadline(runs):
    assert runs["seconds"] < DEADLINE_S


def test_no_process_group_leaks_into_this_process(runs):
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the case builders against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reason_and_batch_specs_equal_jax(runs, arch):
    assert runs["port"]["skip"][arch] == runs["jax"]["skip"][arch]
    assert (runs["port"]["batch_specs"][arch]
            == runs["jax"]["batch_specs"][arch])


def test_variants_equal_jax(runs):
    assert runs["port"]["variants"] == runs["jax"]["variants"]


def _stacked(cfg, port_leaves: dict) -> dict:
    """The port's leaves under JAX's paths: each per-layer parameter (or
    moment) leaf counts one into JAX's stacked leaf ``[n, ...]``."""
    out, count = {}, {}
    for path, (shape, dtype) in port_leaves.items():
        parts = path.split("/")
        moment = parts[0] == "1" and parts[1:2] in (["m"], ["v"])
        head = parts[:2] if moment else parts[:1]
        names = parts[len(head):]
        if (parts[0] == "0" or moment) and names[:1] in (["blocks"],
                                                         ["layers"]):
            jpath, _ = jax_leaf_of(cfg, names)
            key = "/".join(head + list(jpath))
            count[key] = count.get(key, 0) + 1
            out[key] = (shape, dtype)
        else:
            out[path] = [shape, dtype]
    for key, n in count.items():
        shape, dtype = out[key]
        out[key] = [[n] + shape, dtype]
    return out


@pytest.mark.parametrize("cell", _cells())
def test_case_equals_jax(runs, cell):
    """Kind, model FLOPs, and every argument leaf's global shape and dtype
    (the port's per-layer leaves stacked as JAX's)."""
    got, want = runs["port"]["cases"][cell], runs["jax"]["cases"][cell]
    assert got["kind"] == want["kind"]
    assert got["flops"] == want["flops"]
    cfg = get_config(cell.split("|")[0])
    assert _stacked(cfg, got["leaves"]) == want["leaves"]


def test_serve_placements_qwen2_pools_over_kv_hd(runs):
    """qwen2-7b decode on (data 16, kv 4, hd 4): the pools split over kv
    (Hkv 4) and hd (head_dim 128), G over data; table and lengths G over
    data only."""
    p = runs["port"]["placements"]["qwen2-7b|decode_32k|0|2d"]
    assert p["mesh"] == {"data": 16, "kv": 4, "hd": 4}
    for pool in ("k_pools", "v_pools"):
        assert p[pool] == [["S(0)", "S(4)", "S(5)"],
                           [1, 28, 16393, 16, 1, 32]]
    assert p["page_table"] == [["S(0)", "R", "R"], [1, 8, 2049]]
    assert p["seq_lens"] == [["S(0)", "R", "R"], [1, 8]]


def test_serve_placements_rwkv_wkv_over_heads(runs):
    """rwkv6-7b decode on (data 16, kv 16, hd 1): the wkv state's heads
    split over (kv, hd), the shifts' d_model too."""
    p = runs["port"]["placements"]["rwkv6-7b|decode_32k|0|2d"]
    assert p["mesh"] == {"data": 16, "kv": 16, "hd": 1}
    assert p["wkv"] == [["S(0)", "S(3)", "S(3)"], [1, 32, 8, 4, 64, 64]]
    assert p["tm_shift"] == [["S(0)", "S(3)", "S(3)"], [1, 32, 8, 256]]
    assert p["seq_lens"] == [["S(0)", "R", "R"], [1, 8]]


def test_serve_placements_recurrentgemma_hkv1_whole_on_kv(runs):
    """recurrentgemma-9b decode on (data 16, kv 1, hd 16): Hkv 1 stays
    whole on every rank (the kv axis has one rank), head_dim 256 splits
    over hd; the RG-LRU state's width over (kv, hd)."""
    p = runs["port"]["placements"]["recurrentgemma-9b|decode_32k|0|2d"]
    assert p["mesh"] == {"data": 16, "kv": 1, "hd": 16}
    for pool in ("k_pools", "v_pools"):
        assert p[pool] == [["S(0)", "S(4)", "S(5)"],
                           [1, 12, 1041, 16, 1, 16]]
    assert p["rg_h"] == [["S(0)", "S(3)", "S(3)"], [1, 26, 8, 256]]


def test_flat_view_splits_head_dim_over_model(runs):
    """The flat serve mode: the pools' head_dim over 'model', Hkv whole."""
    p = runs["port"]["placements"]["qwen2-7b|decode_32k|0|flat"]
    assert p["mesh"] == {"data": 16, "model": 16}
    assert p["k_pools"] == [["S(0)", "S(5)"], [1, 28, 16393, 16, 4, 8]]


# ---------------------------------------------------------------------------
# launch/dryrun.py's records
# ---------------------------------------------------------------------------


def _cell(runs, name):
    return json.loads((runs["cells"] / name).read_text())


def test_dryrun_records_an_ok_cell(runs):
    r = _cell(runs, "qwen2-7b__decode_32k__pod16x16.json")
    assert r["status"] == "ok" and r["kind"] == "decode" and r["chips"] == 256
    mem = r["memory"]
    assert mem["alias_bytes"] is None and mem["generated_code_bytes"] is None
    # the whole bf16 weights and this rank's pool slices
    pools = 2 * 28 * 16393 * 16 * 1 * 32 * 2
    assert mem["argument_bytes"] > pools + 15e9
    assert 0 < mem["temp_bytes"] and 0 < mem["output_bytes"]
    assert r["trace_s"] > 0
    # one K/V gather over hd and one output gather over kv a layer
    assert r["collectives"]["counts"] == {"all-gather": 56}
    t = r["roofline"]
    assert t["dominant"] == "collective" and t["chips"] == 256
    assert t["collective_s"] == pytest.approx(
        r["collectives"]["total_bytes_per_device"] / costmodel.H100_NET_BW)
    assert set(r["scopes"]["flops"]) <= {
        "attention", "moe", "optimizer", "embedding", "loss", "other",
        "backward"}


def test_dryrun_records_skips_and_errors_as_jax(runs):
    r = _cell(runs, "qwen2-7b__long_500k__pod16x16.json")
    assert r["status"] == "skipped"
    assert r["reason"] == runs["jax"]["skip"]["qwen2-7b"]["long_500k"]
    r = _cell(runs, "rwkv6-7b__train_4k__pod16x16__remat_dots.json")
    assert r["status"] == "error" and r["variant"] == "remat_dots"
    assert r["error"].startswith("TypeError") and "remat_policy" in r["error"]
    assert "Traceback" in r["traceback"]


def test_mesh_step_collectives_equal_the_card_readings(runs):
    """granite-moe's mesh step (chip_smoke.py's) on a fake 8-rank group:
    op_cost's bytes by op_cost's stated relation equal what ``step.comm``
    read on the H100 (PR 33), and ``step.comm`` on meta equals them too."""
    m = runs["port"]["mesh_step"]
    assert m["by_kind"]["all-gather"] * 7 // 8 == CARD_GATHERED
    assert m["by_kind"]["all-reduce"] - m["stats_b"] == CARD_REDUCED
    assert m["comm"] == {"gathered": CARD_GATHERED, "reduced": CARD_REDUCED}
    assert m["counts"]["all-gather"] == 16
