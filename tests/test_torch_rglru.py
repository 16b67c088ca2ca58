"""The port's RG-LRU hybrid (recurrentgemma-9b) against the JAX package, on
the CPU.

Plain versions: ``rglru_scan_ref`` (the step loop of the plain RG-LRU)
against JAX's ``_rglru_scan`` (an associative scan, another order of sums)
at 1e-6; ``rglru_ref`` (the gate math, decay and recurrence of one layer)
against JAX's lines ``src/repro/models/rglru.py:183-189`` run on the same
numpy inputs, with bf16 and f32 weights, at 1e-6 (the bf16 products are
exact in f32 on both sides; only the order of the f32 sums differs); the
windowed ``chunked_attention_ref`` against
JAX's at 1e-5; ``paged_decode_attention_ref`` at recurrentgemma-9b's
decode shape (G 16, D 256) against JAX's oracle, with and without the
window, at 1e-5.

Model: the reduced recurrentgemma-9b (f32, 5 layers: recurrent,
recurrent, local attention and a two-layer recurrent tail, d_model 64,
4 query heads over 1 KV head of 16, window 16) is initialised by the JAX
package, its unit norm scales are redrawn with seeded numpy values, and
the same numpy weights feed both sides through ``params_from_jax``.  JAX
runs ``use_kernels=True`` (the Pallas copy and decode kernels in
interpret mode), as the RWKV-6 tests run it.  Prefill logits and every
field of the returned ``HybridState`` agree within 1e-5 (XLA and torch
sum the contractions in other orders), then greedy decode steps past the
window are token-identical with logits within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.models.rglru import _rglru_scan as jax_rglru_scan
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rglru import rglru as rglru_kernel
from repro_torch.models import (
    HybridState,
    RecurrentGemmaLM,
    build_model,
    params_from_jax,
)

pytestmark = pytest.mark.torch_port

ARCH = "recurrentgemma-9b"
PAGE, MAX_PAGES = 4, 12


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 7, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_ref_matches_jax(steps, with_h0):
    """The step loop against JAX's associative scan, a in (0, 1) as the
    model makes it (``exp(-8 softplus(lam) r)``), within 1e-6."""
    rng = np.random.default_rng(steps + 10 * with_h0)
    b, r = 3, 40
    a = np.exp(-8.0 * np.log1p(np.exp(rng.uniform(0.4, 0.8, r)))
               * rng.uniform(0, 1, (b, steps, r))).astype(np.float32)
    bx = (0.5 * rng.standard_normal((b, steps, r))).astype(np.float32)
    h0 = (rng.standard_normal((b, r)) if with_h0
          else np.zeros((b, r))).astype(np.float32)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    got = ref.rglru_scan_ref(t(a), t(bx), t(h0))
    close(got.numpy(), want, 1e-6)


def rglru_inputs(seed, b, steps, r, dtype, with_h0):
    """f32 numpy inputs of one recurrent layer's RG-LRU: conv and the gate
    weights rounded to ``dtype`` (bf16 values, as the bf16 model's conv
    and weights are), ``lam`` uniform in [0.4, 0.8) and ``h0``."""
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((b, steps, r)).astype(np.float32)
    w_r = (rng.standard_normal((r, r)) / np.sqrt(r)).astype(np.float32)
    w_i = (rng.standard_normal((r, r)) / np.sqrt(r)).astype(np.float32)
    if dtype == "bfloat16":
        conv, w_r, w_i = (np.asarray(jnp.asarray(x, jnp.bfloat16),
                                     np.float32) for x in (conv, w_r, w_i))
    lam = rng.uniform(0.4, 0.8, r).astype(np.float32)
    h0 = (rng.standard_normal((b, r)) if with_h0
          else np.zeros((b, r))).astype(np.float32)
    return conv, w_r, w_i, lam, h0


def jax_rglru(conv, w_r, w_i, lam, h0):
    """JAX's RG-LRU, ``src/repro/models/rglru.py:183-189`` line for line
    (the recurrent block computes it inline)."""
    conv32 = conv.astype(jnp.float32)
    r = jax.nn.sigmoid(conv32 @ w_r.astype(jnp.float32))
    i = jax.nn.sigmoid(conv32 @ w_i.astype(jnp.float32))
    a = jnp.exp(-8.0 * jax.nn.softplus(lam) * r)
    bx = jnp.sqrt(jnp.maximum(1.0 - a * a, 1e-12)) * (i * conv32)
    return jax_rglru_scan(a, bx, h0.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("steps", [1, 7, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_ref_matches_jax(dtype, steps, with_h0):
    """``ref.rglru_ref`` against JAX's gate math and ``_rglru_scan`` on the
    same numpy inputs, within 1e-6 in f32 and in bf16 (bf16 products are
    exact in f32 on both sides; XLA and torch sum the 40 of them in other
    orders); ``ops.rglru`` on CPU tensors is the plain version and moves
    no counter."""
    conv, w_r, w_i, lam, h0 = rglru_inputs(steps + 10 * with_h0, 3, steps,
                                           40, dtype, with_h0)
    jdt = getattr(jnp, dtype)
    want = jax_rglru(jnp.asarray(conv, jdt), jnp.asarray(w_r, jdt),
                     jnp.asarray(w_i, jdt), jnp.asarray(lam),
                     jnp.asarray(h0))
    tdt = getattr(torch, dtype)
    args = (t(conv).to(tdt), t(w_r).to(tdt), t(w_i).to(tdt), t(lam), t(h0))
    got = ref.rglru_ref(*args)
    assert got.dtype == torch.float32 and got.shape == (3, steps, 40)
    close(got.numpy(), want, 1e-6)
    before = (rglru_kernel.launches, dict(rglru_kernel.routes))
    assert torch.equal(ops.rglru(*args), got)
    assert (rglru_kernel.launches, dict(rglru_kernel.routes)) == before


def test_rglru_scan_refusals():
    """``ops.rglru`` refuses on the plain route as the kernel wrapper
    does, and the wrapper takes CUDA tensors only; a refused call moves no
    counter."""
    bf = torch.bfloat16
    conv = torch.rand(2, 5, 8, dtype=bf)
    w = torch.rand(8, 8, dtype=bf)
    lam, h0 = torch.rand(8), torch.zeros(2, 8)
    before = (rglru_kernel.launches, dict(rglru_kernel.routes))
    with pytest.raises(TypeError, match="dtype"):
        ops.rglru(conv.double(), w.double(), w.double(), lam, h0)
    with pytest.raises(TypeError, match="dtype"):
        ops.rglru(conv, w.float(), w, lam, h0)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru(conv, w, w, lam.double(), h0)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru(conv, w, w, lam, h0.to(bf))
    with pytest.raises(ValueError, match="h0"):
        ops.rglru(conv, w, w, lam, torch.zeros(2, 7))
    with pytest.raises(ValueError, match="w_r"):
        ops.rglru(conv, w[:, :7], w, lam, h0)
    with pytest.raises(ValueError, match=r"conv \[B, T, R\]"):
        ops.rglru(conv[0], w, w, lam, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru(conv.transpose(0, 1).contiguous().transpose(0, 1), w, w,
                  lam, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru(conv, w.t(), w, lam, h0)
    with pytest.raises(ValueError, match="lam"):
        ops.rglru(conv, w, w, torch.rand(7), h0)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_kernel(conv, w, w, lam, h0)
    assert (rglru_kernel.launches, dict(rglru_kernel.routes)) == before


@pytest.mark.parametrize("window", [None, 16, 5])
@pytest.mark.parametrize("sq,sk,bk", [(40, 40, 16), (7, 40, 16),
                                      (33, 33, 512)])
def test_chunked_attention_ref_matches_jax(window, sq, sk, bk):
    """Queries at the end of the keys, blocks of ``bk`` keys (a ragged
    last block), GQA with 4 query heads over 2 KV heads, causal, with
    and without the window, within 1e-5."""
    rng = np.random.default_rng(sq + sk + (window or 0))
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, sk, 16)).astype(np.float32)
    want = jref.chunked_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      window=window, bk=bk)
    got = ref.chunked_attention_ref(t(q), t(k), t(v), causal=True,
                                    window=window, bk=bk)
    close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("window", [None, 48])
def test_paged_decode_attention_ref_d256_matches_jax(window):
    """recurrentgemma-9b's decode operands (one KV head, G 16, D 256, page
    16) through ``ops.paged_decode_attention``'s plain route against JAX's
    oracle: ragged lengths, an empty sequence, -1 entries past each
    sequence's pages, a window shorter than the longest sequence."""
    rng = np.random.default_rng(5)
    b, g, d, page, maxp, frames = 4, 16, 256, 16, 8, 40
    lens = np.asarray([100, 0, 17, 128], np.int32)
    q = rng.standard_normal((b, 1, g, d)).astype(np.float32)
    kp = rng.standard_normal((frames, page, 1, d)).astype(np.float32)
    vp = rng.standard_normal((frames, page, 1, d)).astype(np.float32)
    perm = rng.permutation(frames).astype(np.int32)
    table = np.full((b, maxp), -1, np.int32)
    for i, n in enumerate(lens):
        table[i, :-(-n // page)] = perm[i * maxp: i * maxp + -(-n // page)]
    want = jref.paged_decode_attention_ref(
        *(jnp.asarray(x) for x in (q, kp, vp, table, lens)), page_size=page,
        window=window)
    got = ops.paged_decode_attention(*(t(x) for x in (q, kp, vp, table,
                                                      lens)),
                                     page_size=page, window=window)
    close(got.numpy(), want, 1e-5)
    assert float(got[1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """JAX ``init`` weights with the norm scales (all ones there) redrawn,
    as numpy."""
    jm = jax_build_model(jax_get_config(ARCH, reduced=True), remat=False)
    out = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def redraw(tree):
        for val in tree.values():
            if isinstance(val, dict):
                if set(val) == {"scale"}:
                    val["scale"] = (1 + 0.1 * rng.standard_normal(
                        val["scale"].shape)).astype(np.float32)
                else:
                    redraw(val)
    redraw(out)
    return out


@pytest.fixture(scope="module")
def pair(weights):
    jm = jax_build_model(jax_get_config(ARCH, reduced=True), remat=False,
                         use_kernels=True)
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    cfg = get_config(ARCH, reduced=True)
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_jax(weights, cfg, "cpu")


def states(jm, tm, b, n_pages=40, seed=1):
    """A fresh state of each package sharing one page table: distinct
    scrambled frames for every row's pages, the pool's last frame left
    free (the decode scratch row lives there)."""
    rng = np.random.default_rng(seed)
    table = rng.permutation(n_pages - 1)[:b * MAX_PAGES].astype(
        np.int32).reshape(b, MAX_PAGES)
    js = jm.init_state(b, n_pages, PAGE, MAX_PAGES)._replace(
        page_table=jnp.asarray(table))
    ts = tm.init_state(b, n_pages, PAGE, MAX_PAGES)._replace(
        page_table=t(table))
    return js, ts


def prompts(vocab, lens, width, seed=3):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, np.asarray(lens, np.int32)


def assert_state_close(ts, js, tol=1e-5):
    assert isinstance(ts, HybridState)
    for name in ("rg_h", "conv_buf", "k_pools", "v_pools"):
        close(getattr(ts, name).numpy(), getattr(js, name), tol)
    np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                  np.asarray(js.seq_lens))
    np.testing.assert_array_equal(ts.page_table.numpy(),
                                  np.asarray(js.page_table))
    assert ts.rg_h.dtype == torch.float32 and ts.seq_lens.dtype == torch.int32


def greedy(jm, jp, tm, tp, jl, js, tl, ts, steps):
    """``steps`` greedy decode steps on both sides: identical tokens,
    logits within 1e-5.  Returns the last logits and states."""
    for _ in range(steps):
        tok_j = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        tok_t = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tok_t.numpy(), tok_j)
        jl, js = jm.decode_step(jp, jnp.asarray(tok_j), js)
        tl, ts = tm.decode_step(tp, tok_t, ts)
        close(tl.numpy(), jl, 1e-5)
    return jl, js, tl, ts


def test_bridge_unstacks_every_layer(weights):
    """All 5 layers in the pattern's order: ``supers.rec0[0]``,
    ``supers.rec1[0]``, ``supers.attn[0]``, ``tail[0]``, ``tail[1]``."""
    cfg = get_config(ARCH, reduced=True)
    tp = params_from_jax(weights, cfg, "cpu")
    sup = weights["supers"]
    sources = [sup["rec0"], sup["rec1"], sup["attn"], weights["tail"],
               weights["tail"]]
    index = [0, 0, 0, 0, 1]
    assert len(tp["layers"]) == cfg.num_layers == 5

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    for layer, src, i in zip(tp["layers"], sources, index):
        got = dict(leaves(layer))
        want = dict(leaves(src))
        assert got.keys() == want.keys()
        for key, val in want.items():
            np.testing.assert_array_equal(got[key].numpy(), val[i])
    assert tp["layers"][0]["lam"].dtype == torch.float32
    np.testing.assert_array_equal(tp["head"].numpy(), weights["head"])
    np.testing.assert_array_equal(tp["embed"].numpy(), weights["embed"])


def test_prefill_then_greedy_decode_past_the_window_matches_jax(pair):
    """Prefill logits and every state field within 1e-5, then 10 greedy
    decode steps from 12 to 22 cached tokens (past the window of 16, so
    the window masks) with identical tokens and logits, and the final
    states."""
    jm, jp, tm, tp = pair
    toks, pl = prompts(tm.cfg.vocab_size, [12, 12, 12], 12)
    js, ts = states(jm, tm, 3)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(pl), js)
    tl, ts = tm.prefill(tp, t(toks), t(pl), ts)
    close(tl.numpy(), jl, 1e-5)
    assert_state_close(ts, js)
    np.testing.assert_array_equal(ts.seq_lens.numpy(), pl)
    jl, js, tl, ts = greedy(jm, jp, tm, tp, jl, js, tl, ts, 10)
    assert_state_close(ts, js)
    assert ts.seq_lens.tolist() == [22] * 3 > [tm.cfg.local_window] * 3


def test_prefill_longer_than_the_window_then_decode_matches_jax(pair):
    """A 20-token prompt (the prefill's own attention windowed), then 8
    greedy steps."""
    jm, jp, tm, tp = pair
    toks, pl = prompts(tm.cfg.vocab_size, [20, 20], 20, seed=4)
    js, ts = states(jm, tm, 2, seed=2)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(pl), js)
    tl, ts = tm.prefill(tp, t(toks), t(pl), ts)
    close(tl.numpy(), jl, 1e-5)
    jl, js, tl, ts = greedy(jm, jp, tm, tp, jl, js, tl, ts, 8)
    assert_state_close(ts, js)


def test_prefill_with_a_carried_state_matches_jax(pair):
    """A second prefill continues the recurrent slabs of the first (its
    attention restarts at position 0 and rewrites the first pages, as
    JAX's does)."""
    jm, jp, tm, tp = pair
    toks, pl = prompts(tm.cfg.vocab_size, [24, 24], 24, seed=8)
    js, ts = states(jm, tm, 2, seed=3)
    half = jnp.asarray(pl // 2)
    jl, js = jm.prefill(jp, jnp.asarray(toks[:, :12]), half, js)
    tl, ts = tm.prefill(tp, t(toks[:, :12]), t(pl // 2), ts)
    jl, js = jm.prefill(jp, jnp.asarray(toks[:, 12:]), half, js)
    tl, ts = tm.prefill(tp, t(toks[:, 12:]), t(pl // 2), ts)
    close(tl.numpy(), jl, 1e-5)
    assert_state_close(ts, js)
    np.testing.assert_array_equal(ts.seq_lens.numpy(), pl // 2)


@pytest.mark.parametrize("lens", [[1, 1, 1], [1, 0, 1]])
def test_one_token_prefill_takes_the_decode_branch_as_jax(pair, lens):
    """A one-token prompt (T = 1) branches as JAX's does: its K/V row
    written at ``prompt_lens - 1`` and the paged windowed attention, no
    copy (an empty row writes where JAX's gather puts position -1);
    logits and state within 1e-5, then 4 greedy steps."""
    jm, jp, tm, tp = pair
    toks, pl = prompts(tm.cfg.vocab_size, lens, 1, seed=11)
    js, ts = states(jm, tm, 3, seed=6)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(pl), js)
    tl, ts = tm.prefill(tp, t(toks), t(pl), ts)
    close(tl.numpy(), jl, 1e-5)
    assert_state_close(ts, js)
    jl, js, tl, ts = greedy(jm, jp, tm, tp, jl, js, tl, ts, 4)
    assert_state_close(ts, js)
    assert ts.seq_lens.tolist() == [n + 4 for n in lens]


def test_ragged_prompts_keep_jax_padded_state(pair):
    """Ragged prompts: logits at each row's last token, and the carried
    recurrent state taken after the padded width (JAX's behaviour, kept):
    equal to JAX's and unlike a lone prefill of the short row; then 3
    greedy steps."""
    jm, jp, tm, tp = pair
    toks, pl = prompts(tm.cfg.vocab_size, [14, 9], 14, seed=6)
    js, ts = states(jm, tm, 2, seed=4)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(pl), js)
    tl, ts = tm.prefill(tp, t(toks), t(pl), ts)
    close(tl.numpy(), jl, 1e-5)
    assert_state_close(ts, js)
    _, lone = tm.prefill(tp, t(toks[1:, :9]), t(pl[1:]), states(
        jm, tm, 1, seed=5)[1])
    assert not torch.allclose(ts.rg_h[:, 1], lone.rg_h[:, 0], atol=1e-3)
    greedy(jm, jp, tm, tp, jl, js, tl, ts, 3)


def test_golden_prefill_plus_decode_equals_longer_prefill(pair):
    """The port's own golden test (``tests/test_models.py:62-124``):
    prefill then decode steps give the logits of one longer prefill of
    the same tokens, past the window."""
    _, _, tm, tp = pair
    rng = np.random.default_rng(9)
    b, prompt, steps = 2, 10, 8
    tokens = t(rng.integers(0, tm.cfg.vocab_size,
                            (b, prompt + steps)).astype(np.int32))
    table = t(np.arange(b * MAX_PAGES, dtype=np.int32).reshape(b, MAX_PAGES))

    def fresh():
        return tm.init_state(b, b * MAX_PAGES + 1, PAGE, MAX_PAGES)._replace(
            page_table=table)

    logits, state = tm.prefill(tp, tokens[:, :prompt],
                               torch.full((b,), prompt, dtype=torch.int32),
                               fresh())
    for s in range(steps + 1):
        upto = prompt + s
        want, _ = tm.prefill(tp, tokens[:, :upto],
                             torch.full((b,), upto, dtype=torch.int32),
                             fresh())
        torch.testing.assert_close(logits, want, atol=1e-5, rtol=1e-5)
        if s < steps:
            logits, state = tm.decode_step(tp, tokens[:, upto], state)
    assert state.seq_lens.tolist() == [prompt + steps] * b


def test_serve_calls_update_pools_in_place_and_keep_the_slabs(pair):
    """The contract: a serve call writes K/V into the given state's pools
    (in place, as ``TransformerLM``) and returns new recurrent slabs,
    leaving the given state's ``rg_h`` / ``conv_buf`` / ``seq_lens`` as
    they were."""
    _, _, tm, tp = pair
    st = tm.init_state(2, 40, PAGE, MAX_PAGES)._replace(page_table=t(
        np.arange(2 * MAX_PAGES, dtype=np.int32).reshape(2, MAX_PAGES)))
    _, st = tm.prefill(tp, torch.ones((2, 5), dtype=torch.int32),
                       torch.full((2,), 5, dtype=torch.int32), st)
    slabs = [st.rg_h.clone(), st.conv_buf.clone(), st.seq_lens.clone()]
    pools = st.k_pools.clone()
    _, st2 = tm.decode_step(tp, torch.zeros(2, dtype=torch.int32), st)
    for a, b in zip((st.rg_h, st.conv_buf, st.seq_lens), slabs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert st2.k_pools is st.k_pools and st2.v_pools is st.v_pools
    assert not torch.equal(st.k_pools, pools)          # row 5 written
    assert not torch.equal(st2.rg_h, st.rg_h)
    assert st2.seq_lens.tolist() == [6, 6]


def test_serve_path_launches_per_layer(pair, monkeypatch):
    """A spy on the ``ops`` calls: one ``rglru`` a recurrent layer
    and call (4 here, 26 at full width), one ``paged_copy_kv`` an
    attention layer and prefill, one windowed ``paged_decode_attention``
    an attention layer and decode step."""
    _, _, tm, tp = pair
    calls = []
    for name in ("rglru", "paged_copy_kv", "paged_decode_attention"):
        real = getattr(ops, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append((_name, kw.get("window")))
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    st = tm.init_state(2, 40, PAGE, MAX_PAGES)._replace(page_table=t(
        np.arange(2 * MAX_PAGES, dtype=np.int32).reshape(2, MAX_PAGES)))
    _, st = tm.prefill(tp, torch.ones((2, 6), dtype=torch.int32),
                       torch.full((2,), 6, dtype=torch.int32), st)
    assert [c[0] for c in calls] == ["rglru"] * 2 + ["paged_copy_kv"] \
        + ["rglru"] * 2
    calls.clear()
    tm.decode_step(tp, torch.zeros(2, dtype=torch.int32), st)
    assert calls == [("rglru", None)] * 2 + [
        ("paged_decode_attention", tm.cfg.local_window)] \
        + [("rglru", None)] * 2


def test_init_distributions_dtypes_and_default_device(monkeypatch):
    """The port's seeded init draws the JAX package's distributions and
    keeps its dtypes (``lam`` f32 in a bf16 model); deterministic per
    seed; ``build_model`` of the full config is a ``RecurrentGemmaLM`` on
    the card by default, which raises on a machine with none."""
    import dataclasses
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              param_dtype="bfloat16")
    m = build_model(cfg, device="cpu")
    assert isinstance(m, RecurrentGemmaLM)
    assert (m.n_rec, m.n_att) == (4, 1)
    p, p2 = m.init(0), m.init(0)
    torch.testing.assert_close(p["head"], p2["head"], atol=0, rtol=0)
    rec, att = p["layers"][0], p["layers"][2]
    assert rec["lam"].dtype == torch.float32
    assert 0.4 <= float(rec["lam"].min()) and float(rec["lam"].max()) < 0.8
    for name in ("w_gate", "w_x", "conv_w", "w_r", "w_i", "w_out"):
        assert rec[name].dtype == torch.bfloat16, name
    assert rec["w_r"].shape == (m.rdim, m.rdim)
    assert rec["conv_w"].shape == (4, m.rdim)
    assert att["attn"]["wk"].shape == (cfg.d_model, cfg.head_dim)
    st = m.init_state(3, 10, 4, 5)
    assert st.rg_h.shape == (4, 3, m.rdim) and st.rg_h.dtype == torch.float32
    assert st.conv_buf.shape == (4, 3, 3, m.rdim)
    assert st.conv_buf.dtype == torch.bfloat16
    assert st.k_pools.shape == (1, 10, 4, 1, cfg.head_dim)
    assert st.page_size == 4 and int(st.page_table.max()) == -1
    full = get_config(ARCH)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(full)
    with pytest.raises(ValueError, match="hybrid_rglru"):
        RecurrentGemmaLM(get_config("qwen2-7b", reduced=True), device="cpu")
