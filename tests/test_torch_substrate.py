"""The port's training substrate against the JAX package, on the CPU: the
synthetic data stream, the atomic async checkpointer, the train step with
gradient accumulation, activation checkpointing, the auto-resuming
``Trainer``, the straggler monitor and the launchers.

Each class of ``tests/test_substrate.py`` has its counterpart here, plus
the comparisons with JAX:

  * ``SyntheticLMStream.batch`` equal to JAX's bit for bit (every reduced
    arch, steps 0, 1 and 7; and as process 1 of 2);
  * checkpoint leaf names equal to JAX's ``_leaf_paths``; the port
    restores what JAX's ``save`` wrote (f32, bf16, int32); bf16 round
    trips bit for bit; the async snapshot is a copy;
  * ``make_train_step`` against JAX's (jit) from JAX's weights (bridged by
    ``params_from_jax``) on the same stream, every reduced arch, 3 single
    steps and 2 at ``accum_steps=2``: the loss and ``xent`` / ``aux`` /
    ``grad_norm`` / ``lr`` within 1e-5 relative, every parameter within
    1e-4 of its leaf's peak.  Two leaves start at zero, so after a few
    steps they hold nothing but AdamW's normalized updates, which turn a
    gradient entry's relative rounding into the same relative error of
    the step: the K bias of ``qkv_bias`` configs (its gradient is zero in
    exact arithmetic, rounding noise in both packages: held at one
    summed learning rate, O(lr)) and RWKV-6's LoRA ``w_lora_B`` (entries
    at 1e-5 of the leaf's peak carry ~0.5 % relative error: held at 1e-2
    of the summed learning rate);
  * ``remat=True`` gradients equal ``remat=False`` bit for bit, with one
    checkpointed body for each of JAX's scan bodies under grad and none
    under ``torch.no_grad()``;
  * the resume (20 straight steps against 10 + resume + 10) bit for bit,
    and a SIGTERM sent from the heartbeat giving JAX's emergency step;
  * the straggler monitor's events equal JAX's.
"""

import ast
import dataclasses
import importlib.util
import os
import pathlib
import signal
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback shim (see requirements-dev.txt)
    from _prop_fallback import given, settings, st

from repro import checkpoint as jckpt
from repro.checkpoint.checkpoint import _leaf_paths as jax_leaf_paths
from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLMStream as JaxStream
from repro.models import build_model as jax_build_model
from repro.models.config import ShapeConfig as JaxShape
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train import StragglerMonitor as JaxStragglerMonitor
from repro.train import Trainer as JaxTrainer
from repro.train import make_train_step as jax_make_train_step
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMStream, make_global_batch
from repro_torch.kernels import ref
from repro_torch.launch import train as train_launcher
from repro_torch.launch import train_100m
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               global_norm, tree_leaves, tree_map)
from repro_torch.optim.compression import (compress_decompress,
                                           quantize_int8)
from repro_torch.train import (StragglerMonitor, Trainer, make_train_step,
                               value_and_grad)

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
STEP_OPT = dict(base_lr=1e-3, warmup_steps=2, total_steps=10)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def host(batch):
    return {k: t(v) for k, v in batch.items()}


@pytest.fixture
def sigterm_handler():
    """The trainers leave their SIGTERM handler installed (as JAX's does):
    put the previous one back after the test."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


# ---------------------------------------------------------------------------
# the optimizer and compression (counterparts of TestOptimizer and
# TestCompression)
# ---------------------------------------------------------------------------


class TestOptimizer:
    def test_schedule_warmup_and_decay(self):
        cfg = AdamWConfig(base_lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
        lrs = [float(cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                     cfg)) for s in (0, 5, 10, 55, 100)]
        assert lrs[0] == 0.0
        assert lrs[1] == pytest.approx(0.5)
        assert lrs[2] == pytest.approx(1.0)
        assert 0.1 < lrs[3] < 1.0
        assert lrs[4] == pytest.approx(0.1)

    def test_clipping(self):
        clipped, norm = clip_by_global_norm({"a": torch.full((4,), 10.0)},
                                            1.0)
        assert float(norm) == pytest.approx(20.0)
        assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

    def test_adamw_moves_toward_minimum(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = adamw_init(params)
        cfg = AdamWConfig(base_lr=0.5, warmup_steps=0, total_steps=200,
                          weight_decay=0.0)
        for _ in range(100):
            params, state, _ = adamw_update({"w": params["w"]}, state,
                                            params, cfg)
        assert params["w"].abs().max().item() < 0.5

    @settings(max_examples=20, deadline=None)
    @given(st.floats(0.01, 10.0))
    def test_bias_correction_first_step(self, g0):
        params = {"w": torch.tensor([0.0])}
        cfg = AdamWConfig(base_lr=1e-2, warmup_steps=0, total_steps=100_000,
                          weight_decay=0.0)
        params, _, _ = adamw_update({"w": torch.tensor([g0])},
                                    adamw_init(params), params, cfg)
        assert float(params["w"][0]) == pytest.approx(-1e-2, rel=1e-2)


class TestCompression:
    @settings(max_examples=20, deadline=None)
    @given(st.integers(0, 1000))
    def test_error_feedback_unbiased_over_time(self, seed):
        rng = np.random.default_rng(seed)
        err = torch.zeros(64)
        acc_hat, acc_true = np.zeros(64), np.zeros(64)
        for _ in range(20):
            g = t(rng.normal(size=(64,)).astype(np.float32))
            g_hat, err = compress_decompress(g, err)
            acc_hat += g_hat.numpy()
            acc_true += g.numpy()
        resid = np.abs(acc_hat - acc_true).max()
        assert resid <= np.abs(acc_true).max() * 0.2 + 0.2

    def test_wire_format_is_int8(self):
        q, scale = quantize_int8(torch.randn(128) * 3)
        assert q.dtype == torch.int8 and float(scale) > 0


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------


def small_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((2,), dtype=torch.int32)}}


class TestCheckpoint:
    def test_atomic_roundtrip(self, tmp_path):
        tree = small_tree()
        ckpt.save(str(tmp_path), 7, tree)
        assert ckpt.latest_step(str(tmp_path)) == 7
        assert sorted(os.listdir(tmp_path)) == ["step_7"]
        shapes = tree_map(lambda x: torch.empty_like(x, device="meta"), tree)
        out = ckpt.restore(str(tmp_path), 7, shapes)
        for a, b in zip(tree_leaves(out), tree_leaves(tree)):
            assert a.device.type == "cpu" and torch.equal(a, b)

    def test_garbage_collection_keeps_newest(self, tmp_path):
        for s in (1, 2, 3, 4):
            ckpt.save(str(tmp_path), s, {"x": torch.zeros(2)})
        ckpt.garbage_collect(str(tmp_path), keep=2)
        assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]

    def test_async_checkpointer(self, tmp_path):
        ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3):
            ac.save_async(s, {"x": torch.arange(4.0) + s})
        ac.wait()
        assert ckpt.latest_step(str(tmp_path)) == 3
        assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]

    def test_missing_leaf_is_loud(self, tmp_path):
        ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
        with pytest.raises(ValueError, match="missing leaves"):
            ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(2),
                                            "b": torch.zeros(3)})

    def test_layout_and_manifest_as_jax(self, tmp_path):
        """The same files and manifest as JAX's ``save`` of the same
        tree."""
        rng = np.random.default_rng(0)
        np_tree = {"w": rng.standard_normal((3, 2)).astype(np.float32),
                   "blocks": [{"k": np.arange(4, dtype=np.int32)}]}
        ckpt.save(str(tmp_path / "port"), 3, tree_map(t, np_tree))
        jckpt.save(str(tmp_path / "jax"), 3,
                   jax.tree_util.tree_map(jnp.asarray, np_tree))
        pd, jd = tmp_path / "port" / "step_3", tmp_path / "jax" / "step_3"
        assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
        assert ((pd / "manifest.json").read_text()
                == (jd / "manifest.json").read_text())
        for name in os.listdir(jd):
            if name.endswith(".npy"):
                np.testing.assert_array_equal(np.load(pd / name),
                                              np.load(jd / name))


def opt_trees(np_params):
    """The same ``{"params", "opt"}`` tree in both packages."""
    params = tree_map(t, np_params)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return ({"params": params, "opt": adamw_init(params)},
            {"params": jparams, "opt": jax_adamw_init(jparams)})


def nested_np_params(dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((5, 3)).astype(dtype),
            "blocks": [{"attn": {"wq": rng.standard_normal((3, 3)).astype(
                dtype)}, "ln": rng.standard_normal(3).astype(dtype)}
                for _ in range(2)]}


def test_leaf_names_equal_jax_leaf_paths():
    """``{"params", "opt": AdamWState}``: JAX names the state's fields
    ``opt_.step``, ``opt_.m_...``, ``opt_.v_...``."""
    tree, jtree = opt_trees(nested_np_params())
    names = [n for n, _ in ckpt.leaf_paths(tree)]
    assert names == [n for n, _ in jax_leaf_paths(jtree)]
    assert "opt_.step" in names and "opt_.m_blocks_1_attn_wq" in names


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-7b",
                                  "recurrentgemma-9b"])
def test_leaf_names_of_a_model_tree_equal_jax(arch):
    """A model's parameter tree with its ``AdamWState``, built the same
    way in both packages (the port's layout: ``params_from_jax``)."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False)
    np_params = tree_map(lambda x: x.numpy(), model.init(0))
    tree, jtree = opt_trees(np_params)
    assert ([n for n, _ in ckpt.leaf_paths(tree)]
            == [n for n, _ in jax_leaf_paths(jtree)])


def test_restores_what_jax_saved(tmp_path):
    """The port restores a directory that JAX's ``save`` wrote: f32 and
    bf16 parameters, an ``AdamWState`` with its int32 step."""
    np_params = nested_np_params()
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jparams["embed"] = jparams["embed"].astype(jnp.bfloat16)
    jtree = {"params": jparams, "opt": jax_adamw_init(jparams)}
    jtree["opt"] = jtree["opt"]._replace(
        step=jnp.int32(5), m=jax.tree_util.tree_map(lambda x: x + 1.5,
                                                    jtree["opt"].m))
    jckpt.save(str(tmp_path), 5, jtree)
    tree, _ = opt_trees(np_params)
    out = ckpt.restore(str(tmp_path), 5, tree)
    assert type(out["opt"]) is type(tree["opt"])
    jleaves = jax.tree.leaves(jtree)
    for a, b in zip(tree_leaves(out), jleaves):
        if b.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(),
                np.asarray(b).view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(out["opt"].step) == 5


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_round_trip_bit_exact(tmp_path, seed):
    """Every 16-bit pattern a bf16 leaf may hold (NaN payloads, infinities,
    subnormals, -0) comes back bit for bit; the manifest says bfloat16."""
    bits = np.random.default_rng(seed).integers(-2 ** 15, 2 ** 15,
                                                (64, 33)).astype(np.int16)
    bits[0, :4] = [0x7F80, -0x0080, 0x7FC1, -0x8000]   # inf, -inf, NaN, -0
    x = torch.from_numpy(bits).view(torch.bfloat16)
    ckpt.save(str(tmp_path), 1, {"x": x, "y": [x[:3]]})
    out = ckpt.restore(str(tmp_path), 1, {"x": x, "y": [x[:3]]})
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(out["y"][0].view(torch.int16),
                       x[:3].view(torch.int16))
    manifest = (tmp_path / "step_1" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest


def test_async_snapshot_does_not_alias(tmp_path, monkeypatch):
    """``save_async`` copies each leaf before it returns (``.cpu()`` of a
    CPU tensor is the same tensor): an in-place change made while the
    writer waits to start does not reach the checkpoint."""
    import repro_torch.checkpoint.checkpoint as C
    go, real = threading.Event(), C.save

    def held_save(*a):
        assert go.wait(timeout=60)
        return real(*a)
    monkeypatch.setattr(C, "save", held_save)
    tree = {"a": torch.arange(1 << 16, dtype=torch.float32),
            "b": [torch.ones(7, dtype=torch.bfloat16)]}
    want = tree_map(torch.clone, tree)
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save_async(1, tree)
    for x in tree_leaves(tree):
        x.add_(3)
    go.set()
    ac.wait()
    out = ckpt.restore(str(tmp_path), 1, tree)
    for a, b in zip(tree_leaves(out), tree_leaves(want)):
        assert torch.equal(a, b)


def test_restore_onto_a_device(tmp_path):
    ckpt.save(str(tmp_path), 2, small_tree())
    out = ckpt.restore(str(tmp_path), 2, small_tree(), device="cpu")
    assert torch.equal(out["a"], small_tree()["a"])


# ---------------------------------------------------------------------------
# the data stream
# ---------------------------------------------------------------------------


class TestDataPipeline:
    def test_deterministic_by_step(self):
        cfg = get_config("granite-8b", reduced=True)
        shape = ShapeConfig("t", 16, 4, "train")
        s1, s2 = SyntheticLMStream(cfg, shape), SyntheticLMStream(cfg, shape)
        b1, b2 = s1.batch(5), s2.batch(5)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert not np.array_equal(b1["tokens"], s1.batch(6)["tokens"])

    def test_shapes_and_mask(self):
        cfg = get_config("qwen2-vl-7b", reduced=True)
        b = SyntheticLMStream(cfg, ShapeConfig("t", 32, 4, "train")).batch(0)
        assert b["tokens"].shape == (4, 32)
        assert b["positions"].shape == (3, 4, 32)
        assert b["vision_embeds"].shape[0] == 4
        assert set(np.unique(b["mask"])) <= {0.0, 1.0}
        assert (b["mask"] == 0).any()

    def test_audio_batch_has_codebooks(self):
        cfg = get_config("musicgen-large", reduced=True)
        b = SyntheticLMStream(cfg, ShapeConfig("t", 16, 2, "train")).batch(0)
        assert b["tokens"].shape == (2, 16, cfg.num_codebooks)


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 7])
@pytest.mark.parametrize("arch", ARCHS)
def test_stream_equals_jax_bit_for_bit(arch, step):
    """Tokens, labels, the packing mask, and the VLM's vision prefix and
    ``[3, B, S]`` M-RoPE positions (a 2-D grid of 16 positions)."""
    shape = (64, 4)
    got = SyntheticLMStream(get_config(arch, reduced=True),
                            ShapeConfig("t", *shape, "train"),
                            DataConfig(seed=7)).batch(step)
    from repro.data import DataConfig as JaxDataConfig
    want = JaxStream(jax_get_config(arch, reduced=True),
                     JaxShape("t", *shape, "train"),
                     JaxDataConfig(seed=7)).batch(step)
    assert_batches_equal(got, want)


def test_stream_as_process_1_of_2_equals_jax(monkeypatch):
    """The process index and count from ``torch.distributed`` stripe the
    batch as ``jax.process_index()`` / ``jax.process_count()`` do."""
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    stream = SyntheticLMStream(get_config("granite-8b", reduced=True),
                               ShapeConfig("t", 16, 4, "train"))
    assert stream.host_batch_size() == 2
    want = JaxStream(jax_get_config("granite-8b", reduced=True),
                     JaxShape("t", 16, 4, "train")).batch(3)
    assert_batches_equal(stream.batch(3), want)


def test_make_global_batch_puts_the_batch_on_the_device():
    cfg = get_config("qwen2-vl-7b", reduced=True)
    b = SyntheticLMStream(cfg, ShapeConfig("t", 32, 2, "train")).batch(0)
    out = make_global_batch(b, "cpu")
    for k, v in b.items():
        assert out[k].is_contiguous() and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v)


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------


ZERO_START = {"bk": 1.0, "w_lora_B": 1e-2}   # leaf name -> x summed lr


def summed_lr(cfg: AdamWConfig, steps: int) -> float:
    return sum(float(cosine_schedule(torch.tensor(s + 1), cfg))
               for s in range(steps))


def train_against_jax(arch, accum, steps):
    """JAX's jitted step and the port's from the same weights on the same
    stream; returns the worst relative metric gap and the parameters."""
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch,
                                                               reduced=True)
    jm = jax_build_model(jcfg, use_kernels=False)
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             "cpu")
    jo, opt = jax_adamw_init(jp), adamw_init(params)
    jstep = jax_make_train_step(jm, JaxAdamWConfig(**STEP_OPT),
                                accum_steps=accum, donate=False)
    model = build_model(cfg, device="cpu", use_kernels=False)
    step = make_train_step(model, AdamWConfig(**STEP_OPT), accum_steps=accum)
    jstream = JaxStream(jcfg, JaxShape("t", 16, 4, "train"))
    stream = SyntheticLMStream(cfg, ShapeConfig("t", 16, 4, "train"))
    for s in range(steps):
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v)
                                      for k, v in jstream.batch(s).items()})
        params, opt, met = step(params, opt, host(stream.batch(s)))
        assert sorted(met) == sorted(jmet)
        for k in jmet:
            want, got = float(jmet[k]), float(met[k])
            assert abs(got - want) <= LOSS_RTOL * abs(want), (s, k, got,
                                                               want)
    assert int(opt.step) == int(jo.step) == steps
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           "cpu")
    return params, want


@pytest.mark.parametrize("arch,accum,steps", [
    (arch, accum, steps)
    for accum, steps in ((1, 3), (2, 2)) for arch in ARCHS
    # the VLM's [3, B, S] positions do not split: its accumulation is
    # test_vlm_accumulation_refused_in_both
    if accum == 1 or get_config(arch, reduced=True).family != "vlm"])
def test_train_step_matches_jax(arch, accum, steps):
    params, want = train_against_jax(arch, accum, steps)
    lr_sum = summed_lr(AdamWConfig(**STEP_OPT), steps)
    for (name, a), b in zip(ckpt.leaf_paths(params), tree_leaves(want)):
        err = (a - b).abs().max().item()
        leaf = name.rsplit("_", 1)[-1] if not name.endswith(
            "w_lora_B") else "w_lora_B"
        if leaf in ZERO_START:
            assert err <= ZERO_START[leaf] * lr_sum, (name, err, lr_sum)
        else:
            peak = b.abs().max().item()
            assert err <= PARAM_RTOL * peak, (name, err, peak)


def test_vlm_accumulation_refused_in_both():
    """JAX's split reshapes the ``[3, B, S]`` positions along their first
    axis and fails; the port refuses with a ``ValueError`` naming them."""
    jcfg, cfg = (jax_get_config("qwen2-vl-7b", reduced=True),
                 get_config("qwen2-vl-7b", reduced=True))
    jm = jax_build_model(jcfg, use_kernels=False)
    jp = jm.init(jax.random.PRNGKey(0))
    jbatch = JaxStream(jcfg, JaxShape("t", 16, 6, "train")).batch(0)
    jstep = jax_make_train_step(jm, JaxAdamWConfig(**STEP_OPT),
                                accum_steps=2, donate=False)
    with pytest.raises(TypeError, match="reshape"):
        jstep(jp, jax_adamw_init(jp), {k: jnp.asarray(v)
                                       for k, v in jbatch.items()})
    model = build_model(cfg, device="cpu", use_kernels=False)
    params = model.init(0)
    step = make_train_step(model, AdamWConfig(**STEP_OPT), accum_steps=2)
    batch = host(SyntheticLMStream(cfg, ShapeConfig(
        "t", 16, 6, "train")).batch(0))
    with pytest.raises(ValueError, match=r"M-RoPE positions .*\[3, B, S\]"):
        step(params, adamw_init(params), batch)


def test_train_step_refusals_and_inputs_unchanged():
    cfg = get_config("granite-8b", reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False)
    params = model.init(0)
    before = tree_map(torch.clone, params)
    opt = adamw_init(params)
    batch = host(SyntheticLMStream(cfg, ShapeConfig(
        "t", 8, 3, "train")).batch(0))
    # grad_shardings lays the gradients out on a mesh: whole parameters
    # are refused when the step runs
    with pytest.raises(ValueError, match="as DTensors"):
        make_train_step(model, AdamWConfig(), grad_shardings={})(
            params, opt, batch)
    with pytest.raises(ValueError, match="accum_steps 2"):
        make_train_step(model, AdamWConfig(), accum_steps=2)(params, opt,
                                                             batch)
    new, _, _ = make_train_step(model, AdamWConfig())(params, opt, batch)
    for a, b, c in zip(tree_leaves(params), tree_leaves(before),
                       tree_leaves(new)):
        assert torch.equal(a, b) and not a.requires_grad
        assert not c.requires_grad
    assert int(opt.step) == 0


def test_value_and_grad_returns_a_tree_and_leaves_params_untouched():
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False)
    params = model.init(0)
    batch = host(SyntheticLMStream(cfg, ShapeConfig(
        "t", 8, 2, "train")).batch(0))
    loss, met, grads = value_and_grad(model, params, batch)
    assert not loss.requires_grad and sorted(met) == ["aux", "xent"]
    for g, p in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.shape == p.shape and not p.requires_grad
        assert not g.requires_grad


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------


def jax_scan_bodies(cfg) -> int:
    """Bodies JAX's ``jax.checkpoint`` wraps in one forward: a superblock
    of ``moe_every`` layers (transformer), a layer (RWKV-6), a superblock
    ``rec0, rec1, attn`` and each tail layer (RG-LRU)."""
    if cfg.family == "rwkv6":
        return cfg.num_layers
    if cfg.family == "hybrid_rglru":
        n = len(cfg.block_pattern)
        return cfg.num_layers // n + cfg.num_layers % n
    return cfg.num_layers // (cfg.moe_every if cfg.family == "moe" else 1)


@pytest.fixture
def checkpoint_spy(monkeypatch):
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_no_remat_bit_for_bit(arch, checkpoint_spy):
    cfg = get_config(arch, reduced=True)
    batch = host(SyntheticLMStream(cfg, ShapeConfig(
        "t", 16, 2, "train")).batch(0))
    out = {}
    for remat in (False, True):
        model = build_model(cfg, device="cpu", use_kernels=False,
                            remat=remat)
        params = model.init(0)
        checkpoint_spy.clear()
        out[remat] = value_and_grad(model, params, batch)
        assert checkpoint_spy == ([False] * jax_scan_bodies(cfg) if remat
                                  else [])
        checkpoint_spy.clear()
        with torch.no_grad():
            model.loss(params, batch)
        assert checkpoint_spy == []
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)


def test_remat_rwkv_serve_paths_unchanged(checkpoint_spy):
    """``prefill`` runs ``forward`` under no-grad: nothing is wrapped and
    the state is the one ``remat=False`` gives."""
    cfg = get_config("rwkv6-7b", reduced=True)
    tok = torch.randint(0, cfg.vocab_size, (2, 9),
                        generator=torch.Generator().manual_seed(0))
    outs = []
    for remat in (False, True):
        model = build_model(cfg, device="cpu", use_kernels=False,
                            remat=remat)
        params = model.init(0)
        outs.append(model.prefill(params, tok, torch.tensor([9, 9]),
                                  model.init_state(2)))
        h, state = model.forward(params, tok)       # under grad
        assert h.shape == (2, 9, cfg.d_model) and state.wkv.shape == (
            outs[-1][1].wkv.shape)
    assert checkpoint_spy == [False] * cfg.num_layers
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_remat_recomputes_the_flash_backward_with_six_residuals(
        monkeypatch):
    """At S 1,040 every layer's attention is
    ``chunked_attention_flashbwd_ref``: under remat its forward runs twice
    a layer (the recompute), its backward finds its six saved tensors, and
    the gradients equal ``remat=False``'s.  One thread: at 1,040 tokens
    the embedding's index backward adds rows in a thread-dependent order,
    so two ``remat=False`` runs already differ in its last bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        grads = flash_remat_grads(monkeypatch)
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(tree_leaves(grads[True]), tree_leaves(grads[False])):
        assert torch.equal(a, b)


def flash_remat_grads(monkeypatch):
    fn = ref._ChunkedAttentionFlashBwd
    fwd, bwd = [], []
    real_fwd, real_bwd = fn.forward, fn.backward

    def spy_fwd(ctx, *a):
        fwd.append(1)
        return real_fwd(ctx, *a)

    def spy_bwd(ctx, do):
        # a checkpointed tensor unpacks once: hand the real backward what
        # was read here
        saved = ctx.saved_tensors
        bwd.append(len(saved))
        return real_bwd(types.SimpleNamespace(saved_tensors=saved,
                                              opts=ctx.opts), do)
    monkeypatch.setattr(fn, "forward", staticmethod(spy_fwd))
    monkeypatch.setattr(fn, "backward", staticmethod(spy_bwd))
    cfg = get_config("qwen2-7b", reduced=True)
    batch = host(SyntheticLMStream(cfg, ShapeConfig(
        "t", 1040, 1, "train")).batch(0))
    grads = {}
    for remat in (False, True):
        fwd.clear()
        bwd.clear()
        model = build_model(cfg, device="cpu", use_kernels=False,
                            remat=remat)
        grads[remat] = value_and_grad(model, model.init(0), batch)[2]
        assert len(fwd) == cfg.num_layers * (2 if remat else 1)
        assert bwd == [6] * cfg.num_layers
    return grads


# ---------------------------------------------------------------------------
# the trainer: resume and preemption
# ---------------------------------------------------------------------------


def granite_run(ckpt_dir, start_steps, remat=True, ckpt_every=10,
                heartbeat=None):
    cfg = get_config("granite-8b", reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False, remat=remat)
    stream = SyntheticLMStream(cfg, ShapeConfig("t", 16, 4, "train"))
    opt = AdamWConfig(base_lr=1e-3, warmup_steps=2, total_steps=30)
    tr = Trainer(model, opt, ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                 heartbeat=heartbeat)
    p, o, s0 = tr.init_or_restore(0)
    p, o, hist = tr.run(p, o, lambda s: host(stream.batch(s)), s0,
                        start_steps)
    return tr, s0, p, o, hist


@pytest.mark.parametrize("remat", [False, True])
def test_resume_is_bit_identical(tmp_path, remat, sigterm_handler):
    """20 straight steps == 10 steps + a new ``Trainer`` that resumes from
    disk + 10 steps, parameters and optimizer state bit for bit (JAX's
    test holds 1e-6)."""
    _, _, p_straight, o_straight, _ = granite_run(tmp_path / "a", 20,
                                                  remat)
    granite_run(tmp_path / "b", 10, remat)
    tr, s0, p_res, o_res, hist = granite_run(tmp_path / "b", 20, remat)
    assert s0 == 10 and tr.counters.get("steps") == 10
    assert [(e.event, e.payload) for e in tr.counters.fifo] == [
        ("resumed", 10)]
    assert [h["step"] for h in hist] == [10, 19]
    for a, b in zip(tree_leaves({"p": p_straight, "o": o_straight}),
                    tree_leaves({"p": p_res, "o": o_res})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ckpt.latest_step(str(tmp_path / "b")) == 20


def test_sigterm_from_the_heartbeat_checkpoints_as_jax(tmp_path,
                                                       sigterm_handler):
    """A SIGTERM sent from the heartbeat at step 4 (``ckpt_every`` 2):
    both trainers finish the step, take the emergency checkpoint at the
    same step and re-raise; the port's counters say the same."""
    def kill_at(k):
        def hb(step, dt):
            if step == k:
                os.kill(os.getpid(), signal.SIGTERM)
        return hb

    jcfg = jax_get_config("granite-8b", reduced=True)
    jstream = JaxStream(jcfg, JaxShape("t", 16, 4, "train"))
    jtr = JaxTrainer(jax_build_model(jcfg, remat=False),
                     JaxAdamWConfig(base_lr=1e-3, warmup_steps=2,
                                    total_steps=30),
                     ckpt_dir=str(tmp_path / "jax"), ckpt_every=2,
                     heartbeat=kill_at(4))
    jp, jo, js = jtr.init_or_restore(jax.random.PRNGKey(0))
    with pytest.raises(KeyboardInterrupt):
        jtr.run(jp, jo, lambda s: {k: jnp.asarray(v) for k, v in
                                   jstream.batch(s).items()}, js, 10)
    with pytest.raises(KeyboardInterrupt):
        granite_run(tmp_path / "port", 10, ckpt_every=2,
                    heartbeat=kill_at(4))
    steps = {d: sorted(os.listdir(tmp_path / d)) for d in ("jax", "port")}
    assert steps["port"] == steps["jax"] == ["step_2", "step_4", "step_5"]
    assert ckpt.latest_step(str(tmp_path / "port")) == jckpt.latest_step(
        str(tmp_path / "jax")) == 5


def test_preempted_trainer_counts_and_resumes(tmp_path, sigterm_handler):
    def hb(step, dt):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    cfg = get_config("granite-8b", reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False)
    stream = SyntheticLMStream(cfg, ShapeConfig("t", 16, 4, "train"))
    tr = Trainer(model, AdamWConfig(), ckpt_dir=str(tmp_path),
                 ckpt_every=100, heartbeat=hb)
    p, o, s0 = tr.init_or_restore(0)
    with pytest.raises(KeyboardInterrupt):
        tr.run(p, o, lambda s: host(stream.batch(s)), s0, 10)
    assert tr.counters.get("steps") == 3
    assert [(e.event, e.payload) for e in tr.counters.fifo] == [
        ("preempt_checkpoint", 3)]
    tr2 = Trainer(model, AdamWConfig(), ckpt_dir=str(tmp_path))
    _, o2, s2 = tr2.init_or_restore(123)
    assert s2 == 3 and int(o2.step) == 3


# ---------------------------------------------------------------------------
# the straggler monitor
# ---------------------------------------------------------------------------


class TestStragglerMonitor:
    def test_flags_slow_step_and_ewma_excludes_it(self):
        fired = []
        mon = StragglerMonitor(threshold=3.0, warmup_steps=3,
                               on_straggler=fired.append)
        for step in range(10):
            assert not mon.heartbeat(step, 0.1)
        assert mon.heartbeat(10, 1.0)
        assert fired and fired[0].ratio > 3
        assert abs(mon.ewma - 0.1) < 0.02
        assert mon.heartbeat(11, 1.0)

    def test_warmup_suppresses(self):
        mon = StragglerMonitor(threshold=2.0, warmup_steps=5)
        assert not mon.heartbeat(0, 0.1)
        assert not mon.heartbeat(1, 10.0)

    def test_gradual_drift_adapts(self):
        mon = StragglerMonitor(threshold=3.0, alpha=0.5, warmup_steps=2)
        t_step = 0.1
        for step in range(30):
            assert not mon.heartbeat(step, t_step), (step, mon.ewma)
            t_step *= 1.2


def straggler_sequences():
    seeded = np.random.default_rng(3).lognormal(-2.0, 0.8, 200)
    seeded[[40, 41, 90, 150]] *= 6.0
    return {
        "slow_step": (dict(threshold=3.0, warmup_steps=3),
                      [0.1] * 10 + [1.0, 1.0]),
        "warmup": (dict(threshold=2.0, warmup_steps=5), [0.1, 10.0]),
        "drift": (dict(threshold=3.0, alpha=0.5, warmup_steps=2),
                  [0.1 * 1.2 ** i for i in range(30)]),
        "seeded": (dict(threshold=2.5, alpha=0.2, warmup_steps=4),
                   seeded.tolist()),
    }


@pytest.mark.parametrize("name", sorted(straggler_sequences()))
def test_straggler_events_equal_jax(name):
    kw, seq = straggler_sequences()[name]
    mon, jmon = StragglerMonitor(**kw), JaxStragglerMonitor(**kw)
    flags = [mon.heartbeat(i, s) for i, s in enumerate(seq)]
    jflags = [jmon.heartbeat(i, s) for i, s in enumerate(seq)]
    assert flags == jflags and mon.ewma == jmon.ewma
    assert ([dataclasses.asdict(e) for e in mon.events]
            == [dataclasses.asdict(e) for e in jmon.events])
    if name == "seeded":
        assert mon.events


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def launch(tmp_path, *argv):
    return train_launcher.main(["--arch", "granite-8b", "--reduced",
                                "--device", "cpu", "--seq-len", "16",
                                "--global-batch", "4", "--ckpt-dir",
                                str(tmp_path), *argv])


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys,
                                                sigterm_handler):
    hist = launch(tmp_path, "--steps", "6", "--ckpt-every", "3")
    out = capsys.readouterr().out
    assert [h["step"] for h in hist] == [0, 5]
    assert "resumed" not in out and "final loss:" in out
    assert sorted(os.listdir(tmp_path / "granite-8b-reduced")) == [
        "step_3", "step_6"]
    hist = launch(tmp_path, "--steps", "9", "--ckpt-every", "3")
    out = capsys.readouterr().out
    assert out.startswith("resumed from step 6\n")
    assert [h["step"] for h in hist] == [8]
    assert launch(tmp_path, "--steps", "9") == []
    assert "no step to run" in capsys.readouterr().out


def test_launcher_accumulates(tmp_path, sigterm_handler):
    hist = launch(tmp_path, "--steps", "2", "--accum-steps", "2")
    assert sorted(hist[0]) == ["grad_norm", "loss", "lr", "step"]


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_launcher_refuses_a_mesh(tmp_path, flag, monkeypatch):
    """A mesh with no process group and no ``RANK`` / ``WORLD_SIZE``: the
    launcher exits with a message that names torchrun (the mesh runs are
    ``tests/test_torch_train_mesh.py``'s)."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=f"{flag} 2.*torchrun"):
        launch(tmp_path, "--steps", "1", flag, "2")


def test_launcher_without_device_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launcher.main(["--arch", "granite-8b", "--reduced",
                             "--ckpt-dir", str(tmp_path)])


def argparse_defaults(path) -> dict:
    """``{flag: default}`` of every ``add_argument`` call in ``path``."""
    out = {}
    for node in ast.walk(ast.parse(pathlib.Path(path).read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            try:
                value = ast.literal_eval(kw["default"]) if "default" in kw \
                    else None
            except ValueError:
                value = ast.unparse(kw["default"])
            out[node.args[0].value] = value
    return out


def test_train_100m_is_the_example():
    """The lm-100m config field for field, its parameter count, and the
    example's flags and defaults (the port adds ``--device``)."""
    spec = importlib.util.spec_from_file_location(
        "example_train_100m", ROOT / "examples" / "train_100m.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert (dataclasses.asdict(train_100m.CFG)
            == dataclasses.asdict(example.CFG))
    assert train_100m.CFG.param_count() == example.CFG.param_count()
    assert round(train_100m.CFG.param_count() / 1e6, 2) == 79.95
    ours = argparse_defaults(train_100m.__file__)
    assert ours.pop("--device") is None
    assert ours == argparse_defaults(ROOT / "examples" / "train_100m.py")
    src = pathlib.Path(train_100m.__file__).read_text()
    for literal in ("base_lr=1e-3, warmup_steps=20", "ckpt_every=100",
                    "DataConfig(seed=7)", "log_every=25", "drop > 0.5",
                    "remat=True"):
        assert literal in src


def test_launcher_flags_are_jax_flags_and_device():
    ours = argparse_defaults(train_launcher.__file__)
    jax_flags = argparse_defaults(ROOT / "src" / "repro" / "launch"
                                  / "train.py")
    assert ours.pop("--device") is None
    assert ours.pop("--dist-init") == "env://"
    assert "repro_torch_ckpt" in ours.pop("--ckpt-dir")
    jax_flags.pop("--ckpt-dir")
    assert ours == jax_flags
