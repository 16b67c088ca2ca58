"""Training in the port against the JAX package, on the CPU: the losses,
their gradients, the flash-backward attention, AdamW and int8 compression.

The JAX package initialises each reduced config (f32) and its
``use_kernels=False``, ``remat=False`` model computes the loss and
``jax.grad``; the port gets the same numpy weights through
``params_from_jax`` and the same numpy batch (tokens, labels and a mask
with zeros, made from a seed), and computes its loss and
``torch.autograd.grad``.  JAX's gradient pytree maps onto the port's
layout through the same ``params_from_jax``.

Tolerances: the loss 1e-5 relative; each gradient leaf ``1e-4 * max|g| +
1e-7`` against JAX's (the floor for leaves JAX leaves at zero: experts no
token reached); the flash backward 1e-5 of each leaf's peak in f32 and one
bf16 step of it in bf16; AdamW 1e-6 of each leaf's peak, given JAX's own
gradients; the compression bit-identical.  RWKV-6's gradients come from
``wkv6_ref`` in the port and from the chunk-checkpointed
``wkv6_chunked_ref`` in JAX, the same sums; they agree within 1e-5 of
each leaf's peak, inside the common 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as JR
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro.optim import compression as JC
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import layers as L
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.optim import compression as C

pytestmark = pytest.mark.torch_port

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7


def t(a):
    return torch.from_numpy(np.array(a))


def batch_np(cfg, b=2, s=16, seed=0):
    """Tokens, labels and a mask with zeros (numpy, from ``seed``); VLM
    adds M-RoPE positions and a 4-position stub vision prefix."""
    rng = np.random.default_rng(seed)
    audio = cfg.family == "audio" and cfg.num_codebooks > 1
    shape = (b, s + 1, cfg.num_codebooks) if audio else (b, s + 1)
    tok = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
           "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        out["positions"] = np.stack([pos, pos // 2, pos % 5]).astype(np.int32)
        out["vision_embeds"] = (rng.standard_normal((b, 4, cfg.d_model))
                                * 0.02).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def jax_loss_grads(arch, b=2, s=16, **model_kw):
    """(numpy params, the batch, JAX's loss, numpy grads) of reduced
    ``arch`` under ``use_kernels=False``, ``remat=False``."""
    cfg = jax_get_config(arch, reduced=True)
    jm = jax_build_model(cfg, remat=False, use_kernels=False, **model_kw)
    jp = jm.init(jax.random.PRNGKey(0))
    bn = batch_np(cfg, b=b, s=s)
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in bn.items()})
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return np_tree(jp), bn, float(loss), np_tree(grads)


def port_loss_grads(arch, np_params, bn, **model_kw):
    """The port's (loss, metrics, grads tree, model, params) on the CPU,
    with ``remat=False`` as JAX's model is built."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False, remat=False,
                        **model_kw)
    params = params_from_jax(np_params, cfg, "cpu")
    tree_map(lambda x: x.requires_grad_(True), params)
    loss, metrics = model.loss(params, {k: t(v) for k, v in bn.items()})
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss, metrics, tree_unflatten(params, grads), model, params


def assert_grads_close(got, want, rtol=GRAD_RTOL, floor=GRAD_FLOOR):
    for path, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        peak = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert np.isfinite(err) and err <= rtol * peak + floor, (
            path, tuple(a.shape), err, peak)


def check_against_jax(arch, **model_kw):
    np_params, bn, jloss, jgrads = jax_loss_grads(arch, **model_kw)
    cfg = get_config(arch, reduced=True)
    loss, _, grads, _, _ = port_loss_grads(arch, np_params, bn, **model_kw)
    assert abs(loss.item() - jloss) <= LOSS_RTOL * abs(jloss), (
        loss.item(), jloss)
    assert_grads_close(grads, params_from_jax(jgrads, cfg, "cpu"))


# ---------------------------------------------------------------------------
# losses and gradients, every family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """Every arch, reduced: the loss and every gradient leaf."""
    check_against_jax(arch)


@pytest.mark.parametrize("dispatch,cf", [
    ("sorted", 0.5),    # capacity 4 a row: at most 16 of 32 assignments kept
    ("ragged", 1.25), ("dense", 1.25)])
def test_moe_dispatches_match_jax(dispatch, cf):
    """The training MoE dispatches (sorted with drops, ragged through
    ``ops.ragged_dot``'s plain version, dense) and the aux loss."""
    check_against_jax("granite-moe-1b-a400m", moe_dispatch=dispatch,
                      capacity_factor=cf)


def test_moe_aux_per_superblock_as_jax():
    """llama4 (``moe_every`` 2): the aux loss summed over a superblock's
    layers and averaged over superblocks, added at 0.01."""
    np_params, bn, jloss, _ = jax_loss_grads("llama4-maverick-400b-a17b")
    cfg = jax_get_config("llama4-maverick-400b-a17b", reduced=True)
    jm = jax_build_model(cfg, remat=False, use_kernels=False)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    _, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in bn.items()})
    loss, met, _, _, _ = port_loss_grads("llama4-maverick-400b-a17b",
                                         np_params, bn)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]),
                               rtol=1e-6)
    np.testing.assert_allclose(met["xent"].item(), float(jmet["xent"]),
                               rtol=1e-6)
    assert met["aux"].item() > 0
    np.testing.assert_allclose(loss.item(), met["xent"].item()
                               + 0.01 * met["aux"].item(), rtol=1e-6)


def test_long_sequence_takes_the_flash_backward(monkeypatch):
    """A reduced dense model at S 1,040 (> 1,024): every layer's attention
    goes through ``chunked_attention_flashbwd_ref`` (a spy counts), and
    the loss and gradients match JAX's."""
    calls = []
    real = ref.chunked_attention_flashbwd_ref

    def spy(*a, **kw):
        calls.append(kw.get("window"))
        return real(*a, **kw)
    monkeypatch.setattr(ref, "chunked_attention_flashbwd_ref", spy)
    np_params, bn, jloss, jgrads = jax_loss_grads("qwen2-7b", b=1, s=1040)
    cfg = get_config("qwen2-7b", reduced=True)
    loss, _, grads, _, _ = port_loss_grads("qwen2-7b", np_params, bn)
    assert calls == [None] * cfg.num_layers
    assert abs(loss.item() - jloss) <= LOSS_RTOL * abs(jloss)
    assert_grads_close(grads, params_from_jax(jgrads, cfg, "cpu"))


def test_short_sequence_takes_the_plain_attention(monkeypatch):
    monkeypatch.setattr(ref, "chunked_attention_flashbwd_ref", None)
    cfg = get_config("qwen2-7b", reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False)
    params = model.init(0)
    bn = batch_np(cfg, s=1024)
    loss, _ = model.loss(params, {k: t(v) for k, v in bn.items()})
    assert torch.isfinite(loss)


def test_rglru_attention_takes_the_windowed_flash_backward(monkeypatch):
    calls = []
    real = ref.chunked_attention_flashbwd_ref

    def spy(*a, **kw):
        calls.append(kw.get("window"))
        return real(*a, **kw)
    monkeypatch.setattr(ref, "chunked_attention_flashbwd_ref", spy)
    np_params, bn, _, _ = jax_loss_grads("recurrentgemma-9b")
    cfg = get_config("recurrentgemma-9b", reduced=True)
    port_loss_grads("recurrentgemma-9b", np_params, bn)
    n_att = sum(k != "rglru" for k in cfg._full_pattern())
    assert n_att > 0 and calls == [cfg.local_window] * n_att


def test_rwkv_forward_stays_no_grad_in_serving():
    """``prefill`` / ``decode_step`` build no graph; ``forward`` does."""
    cfg = get_config("rwkv6-7b", reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False)
    params = model.init(0)
    tree_map(lambda x: x.requires_grad_(True), params)
    tok = torch.randint(0, cfg.vocab_size, (2, 5))
    logits, _ = model.prefill(params, tok, torch.tensor([5, 5]),
                              model.init_state(2))
    assert not logits.requires_grad
    h, _ = model.forward(params, tok)
    assert h.requires_grad


# ---------------------------------------------------------------------------
# the flash custom VJP
# ---------------------------------------------------------------------------


def attn_inputs(b, hq, hkv, sq, sk, d, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    return q, k, v, do


def jax_vjp(q, k, v, do, dtype, window):
    f = functools.partial(JR.chunked_attention_flashbwd_ref, causal=True,
                          window=window)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def port_vjp(q, k, v, do, dtype, window):
    args = [t(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = ref.chunked_attention_flashbwd_ref(*args, causal=True,
                                             window=window)
    grads = torch.autograd.grad(out, args, t(do).to(dtype))
    for g, a in zip(grads, args):
        assert g.dtype == a.dtype
    return [x.float().detach().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(1100, 1100), (300, 1100)])
def test_flash_backward_matches_jax(dtype, window, sq, sk):
    """Output, dq, dk, dv against ``jax.vjp`` of JAX's custom VJP: a
    ragged last key block (1,100 = 2 x 512 + 76), G 2, queries at the end
    of the keys, with and without a window; f32 within 1e-5 of each
    leaf's peak, bf16 within one bf16 step of it."""
    q, k, v, do = attn_inputs(1, 4, 2, sq, sk, 16)
    want = jax_vjp(q, k, v, do, getattr(jnp, dtype), window)
    got = port_vjp(q, k, v, do, getattr(torch, dtype), window)
    rel = 1e-5 if dtype == "float32" else 2.0 ** -8
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        peak = np.abs(b).max()
        assert np.abs(a - b).max() <= rel * peak, (name, np.abs(a - b).max(),
                                                    peak)


def test_flash_backward_equals_autograd_of_plain_attention():
    """The custom VJP's gradients against autograd through the plain
    softmax (``flash_attention_ref``), f32, no window."""
    q, k, v, do = attn_inputs(2, 4, 2, 600, 600, 8, seed=3)
    got = port_vjp(q, k, v, do, torch.float32, None)
    args = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = ref.flash_attention_ref(*args, causal=True)
    want = [out.detach().numpy()] + [
        g.numpy() for g in torch.autograd.grad(out, args, t(do))]
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_flash_backward_keeps_o_sq_residuals():
    """The forward saves q, k, v, out, m and l only: no [Sq, Sk] score
    matrix is held for the backward."""
    q, k, v, _ = attn_inputs(1, 4, 2, 1100, 1100, 16)
    args = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = ref.chunked_attention_flashbwd_ref(*args)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6
    assert sum(s.numel() for s in saved) == (
        3 * 4 * 1100 * 16 + 2 * 4 * 1100)     # q, out; k, v; m, l


def test_chunked_attention_forward_unchanged():
    """The flash-backward forward is ``chunked_attention_ref``'s, bit for
    bit."""
    q, k, v, _ = attn_inputs(1, 4, 2, 700, 700, 16)
    a = ref.chunked_attention_ref(t(q), t(k), t(v), window=100)
    b = ref.chunked_attention_flashbwd_ref(t(q), t(k), t(v), window=100)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# softmax cross entropy and the windowed attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask", ["none", "some", "all_zero"])
def test_softmax_xent_matches_jax(mask):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    m = {"none": None,
         "some": (rng.random((2, 5)) > 0.4).astype(np.float32),
         "all_zero": np.zeros((2, 5), np.float32)}[mask]
    want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if m is None else jnp.asarray(m))
    got = L.softmax_xent(t(logits), t(labels), None if m is None else t(m))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("window", [1, 5, 64])
def test_windowed_attention_matches_jax(window):
    q, k, v, _ = attn_inputs(2, 4, 2, 40, 40, 8, seed=5)
    want = JL._windowed_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window)
    got = L._windowed_attention(t(q), t(k), t(v), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# AdamW, the schedule, compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 2, 5, 10, 11, 55, 99, 100, 150])
def test_cosine_schedule_matches_jax(step):
    cfg = dict(base_lr=3e-3, warmup_steps=10, total_steps=100,
               min_lr_frac=0.1)
    want = jax_cosine_schedule(jnp.int32(step), JaxAdamWConfig(**cfg))
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                          AdamWConfig(**cfg))
    assert got.dtype == torch.float32
    assert got.item() == float(want)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(steps, moments, param_dtype):
    """``adamw_update`` given JAX's own gradients (reduced granite-moe's,
    scaled x10 so the clip is active), params within 1e-6 of each leaf's
    peak, moments likewise, lr and grad norm equal."""
    np_params, _, _, np_grads = jax_loss_grads("granite-moe-1b-a400m")
    jdt = getattr(jnp, param_dtype)
    cfg_kw = dict(base_lr=1e-2, warmup_steps=2, total_steps=10,
                  moment_dtype=moments)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), np_params)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a * 10, jdt), np_grads)
    cfg = get_config("granite-moe-1b-a400m", reduced=True)

    def bridge(tree, dtype):
        """JAX's tree, every leaf of ``dtype``, in the port's layout."""
        f32 = jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)), tree)
        return tree_map(lambda x: x.to(getattr(torch, dtype)),
                        params_from_jax(f32, cfg, "cpu"))
    tp, tg = bridge(jp, param_dtype), bridge(jg, param_dtype)
    jstate = jax_adamw_init(jp, moments)
    tstate = adamw_init(tp, moments)
    jcfg, tcfg = JaxAdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    for _ in range(steps):
        jp, jstate, jmet = jax_adamw_update(jg, jstate, jp, jcfg)
        tp, tstate, tmet = adamw_update(tg, tstate, tp, tcfg)
    assert tmet["grad_norm"].item() > 1.0            # clipping active
    np.testing.assert_allclose(tmet["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=1e-6)
    assert tmet["lr"].item() == float(jmet["lr"])
    assert int(tstate.step) == int(jstate.step) == steps
    for got, want, dtype in ((tp, jp, param_dtype), (tstate.m, jstate.m,
                                                     moments),
                             (tstate.v, jstate.v, moments)):
        for a, b in zip(tree_leaves(got), tree_leaves(bridge(want, dtype))):
            assert a.dtype == b.dtype
            err = (a.float() - b.float()).abs().max().item()
            assert err <= 1e-6 * b.float().abs().max().item(), err


def test_adamw_does_not_change_its_inputs():
    params = {"w": torch.ones(4), "blocks": [{"b": torch.zeros(2)}]}
    state = adamw_init(params)
    grads = tree_map(torch.ones_like, params)
    adamw_update(grads, state, params, AdamWConfig(warmup_steps=0))
    assert torch.equal(params["w"], torch.ones(4))
    assert int(state.step) == 0 and state.m["w"].abs().sum() == 0


def test_tree_helpers_rebuild_adamw_state_as_jax():
    """``tree_map`` / ``tree_unflatten`` over ``{"params", "opt"}`` rebuild
    the ``AdamWState`` NamedTuple with its fields in order, and
    ``tree_leaves`` keeps ``jax.tree.leaves``' order for the same tree
    built in JAX (the checkpointer walks this tree)."""
    rng = np.random.default_rng(0)
    np_params = {"w": rng.standard_normal((3, 2)).astype(np.float32),
                 "blocks": [{"b": rng.standard_normal(4).astype(np.float32),
                             "a": rng.standard_normal(1).astype(np.float32)}
                            for _ in range(2)]}
    params = tree_map(t, np_params)
    tree = {"params": params, "opt": adamw_init(params)}
    mapped = tree_map(lambda x: x + 1, tree)
    assert type(mapped["opt"]) is type(tree["opt"])
    assert mapped["opt"]._fields == ("step", "m", "v")
    assert int(mapped["opt"].step) == 1
    rebuilt = tree_unflatten(tree, tree_leaves(mapped))
    assert type(rebuilt["opt"]) is type(tree["opt"])
    for a, b in zip(tree_leaves(rebuilt), tree_leaves(mapped)):
        assert a is b
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jtree = {"params": jparams, "opt": jax_adamw_init(jparams)}
    jmapped = jax.tree_util.tree_map(lambda x: x + 1, jtree)
    jleaves = jax.tree.leaves(jmapped)
    leaves = tree_leaves(mapped)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_bit_identical_to_jax(seed):
    """``quantize_int8`` and 20 rounds of ``compress_decompress`` with
    error feedback, f32 and bf16 gradients: the same bytes as JAX."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(257) * 3).astype(np.float32)
    jq, js = JC.quantize_int8(jnp.asarray(x))
    tq, ts = C.quantize_int8(t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(C.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))
    for dtype in ("float32", "bfloat16"):
        jerr = JC.init_error_state({"g": jnp.zeros(64)})["g"]
        terr = C.init_error_state({"g": torch.zeros(64)})["g"]
        for _ in range(20):
            g = (rng.standard_normal(64)).astype(np.float32)
            jhat, jerr = JC.compress_decompress(
                jnp.asarray(g, getattr(jnp, dtype)), jerr)
            that, terr = C.compress_decompress(
                t(g).to(getattr(torch, dtype)), terr)
            np.testing.assert_array_equal(
                that.float().numpy(), np.asarray(jhat.astype(jnp.float32)))
            np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))


def test_loss_decreases_dense_as_jax():
    """The counterpart of ``test_loss_decreases_dense``: reduced
    granite-8b, AdamW at 3e-3, 15 steps on one batch; the first 5 losses
    within 1e-4 of JAX's, the last below 0.9 x the first."""
    jcfg = jax_get_config("granite-8b", reduced=True)
    jm = jax_build_model(jcfg, remat=False, use_kernels=False)
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    bn = batch_np(jcfg, b=4, s=32, seed=1)
    del bn["mask"]
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    ocfg = dict(base_lr=3e-3, warmup_steps=2, total_steps=30)
    jcfg_o = JaxAdamWConfig(**ocfg)

    @jax.jit
    def jstep(p, o):
        (loss, _), g = jax.value_and_grad(jm.loss, has_aux=True)(p, jb)
        p2, o2, _ = jax_adamw_update(g, o, p, jcfg_o)
        return p2, o2, loss

    jo, jlosses = jax_adamw_init(jp), []
    for _ in range(5):
        jp, jo, loss = jstep(jp, jo)
        jlosses.append(float(loss))

    cfg = get_config("granite-8b", reduced=True)
    model = build_model(cfg, device="cpu", use_kernels=False)
    params = params_from_jax(np_params, cfg, "cpu")
    opt, tcfg = adamw_init(params), AdamWConfig(**ocfg)
    tb = {k: t(v) for k, v in bn.items()}
    losses = []
    for _ in range(15):
        tree_map(lambda x: x.requires_grad_(True), params)
        loss, _ = model.loss(params, tb)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        params, opt, _ = adamw_update(tree_unflatten(params, grads), opt,
                                      params, tcfg)
        losses.append(loss.item())
    np.testing.assert_allclose(losses[:5], jlosses, rtol=1e-4)
    assert losses[-1] < 0.9 * losses[0], losses


# ---------------------------------------------------------------------------
# the refusal: no hand-written kernel under grad
# ---------------------------------------------------------------------------


def _wrapper_calls():
    """``(name, call(requires_grad))`` for every kernel wrapper of ``ops``
    on small CPU inputs."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    page, table = 4, torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    lens = torch.tensor([5, 3], dtype=torch.int32)
    rq = lambda x, r: x.requires_grad_(r)       # noqa: E731
    sizes = torch.tensor([2, 0, 3], dtype=torch.int32)
    return {
        "matmul": lambda r: ops.matmul(rq(rnd(3, 8), r), rnd(8, 8)),
        "ragged_dot": lambda r: ops.ragged_dot(rq(rnd(5, 8), r),
                                               rnd(3, 8, 8), sizes),
        "flash_attention": lambda r: ops.flash_attention(
            rq(rnd(1, 4, 6, 8), r), rnd(1, 2, 6, 8), rnd(1, 2, 6, 8)),
        "paged_decode_attention": lambda r: ops.paged_decode_attention(
            rq(rnd(2, 2, 2, 8), r), rnd(4, page, 2, 8), rnd(4, page, 2, 8),
            table, lens, page_size=page),
        "paged_prefill_attention": lambda r: ops.paged_prefill_attention(
            rq(rnd(2, 3, 2, 2, 8), r), rnd(4, page, 2, 8),
            rnd(4, page, 2, 8), table, torch.tensor([2, 1], dtype=torch.int32),
            page_size=page),
        "paged_copy": lambda r: ops.paged_copy(
            rq(rnd(2, 5, 16), r), torch.zeros(4, page, 16), table, lens,
            page_size=page),
        "paged_copy_at": lambda r: ops.paged_copy_at(
            rq(rnd(2, 2, 16), r), torch.zeros(4, page, 16), table,
            torch.tensor([1, 0], dtype=torch.int32),
            torch.tensor([2, 2], dtype=torch.int32), page_size=page),
        "paged_copy_kv": lambda r: ops.paged_copy_kv(
            rq(rnd(2, 5, 16), r), rnd(2, 5, 16), torch.zeros(4, page, 16),
            torch.zeros(4, page, 16), table, lens, page_size=page),
        "paged_copy_kv_at": lambda r: ops.paged_copy_kv_at(
            rq(rnd(2, 2, 16), r), rnd(2, 2, 16), torch.zeros(4, page, 16),
            torch.zeros(4, page, 16), table,
            torch.tensor([1, 0], dtype=torch.int32),
            torch.tensor([2, 2], dtype=torch.int32), page_size=page),
        "paged_gather": lambda r: ops.paged_gather(
            rq(rnd(4, page, 16), r), table[0],
            torch.tensor([0, 5, 2], dtype=torch.int32), page_size=page),
        "rglru": lambda r: ops.rglru(rq(rnd(2, 3, 8), r), rnd(8, 8),
                                     rnd(8, 8), rnd(8), torch.zeros(2, 8)),
        "wkv6": lambda r: ops.wkv6(rq(rnd(2, 3, 8), r), rnd(2, 3, 8),
                                   rnd(2, 3, 8), torch.rand(2, 3, 8),
                                   rnd(2, 8)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_every_wrapper_refuses_inputs_that_require_grad(name):
    """On the CPU route as on the card's: a kernel call under grad mode
    with an input that requires grad raises, naming the kernel; the same
    call without grad, under ``torch.no_grad()`` or with
    ``use_kernel=False`` (where the wrapper takes it) runs."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name}: .*use_kernels=False"):
        call(True)
    call(False)
    with torch.no_grad():
        call(True)


def test_plain_route_stays_differentiable():
    """``use_kernel=False`` under grad takes the plain version, in the
    graph."""
    x = torch.randn(3, 8, requires_grad=True)
    y = ops.matmul(x, torch.randn(8, 4), use_kernel=False)
    assert y.grad_fn is not None
    q = torch.randn(1, 4, 6, 8, requires_grad=True)
    o = ops.flash_attention(q, torch.randn(1, 2, 6, 8),
                            torch.randn(1, 2, 6, 8), use_kernel=False)
    o.sum().backward()
    assert q.grad is not None and q.grad.abs().sum() > 0


@pytest.mark.parametrize("arch,kw,kernel", [
    ("qwen2-7b", {}, "flash_attention"),
    ("granite-moe-1b-a400m", {"moe_dispatch": "ragged"}, "flash_attention"),
    ("recurrentgemma-9b", {}, "rglru"),
    ("rwkv6-7b", {}, "wkv6")])
def test_grad_loss_with_kernels_raises_and_no_grad_runs(arch, kw, kernel):
    """A grad-enabled loss of a ``use_kernels=True`` model raises at its
    first kernel; under ``torch.no_grad()`` it runs and equals the
    ``use_kernels=False`` loss."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="cpu", **kw)
    plain = build_model(cfg, device="cpu", use_kernels=False, **kw)
    params = model.init(0)
    bn = {k: t(v) for k, v in batch_np(cfg).items()}
    want = plain.loss(params, bn)[0]
    tree_map(lambda x: x.requires_grad_(True), params)
    with pytest.raises(RuntimeError, match=f"^{kernel}: "):
        model.loss(params, bn)
    with torch.no_grad():
        got = model.loss(params, bn)[0]
    assert got.item() == pytest.approx(want.item(), rel=1e-6)
