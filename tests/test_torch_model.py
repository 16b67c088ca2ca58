"""Port layers and the dense transformer's serve paths against JAX.

The reduced qwen2-7b (float32, 2 layers, d_model 56, head_dim 14, G = 2)
is initialised by the JAX package, its QKV biases and norm scales are
perturbed with seeded numpy values (JAX initialises them to zeros and ones,
so a bridge that dropped them would still pass), and the same numpy
weights feed both sides through ``params_from_jax``.

Tolerances: layers 1e-5 (f32, elementwise up to a short reduction);
prefill logits atol = rtol = 1e-4 (XLA and torch sum the d_model
contractions in different orders); KV pools after prefill and decode 1e-5
for f32 pools; int8 pools at most one quantization step apart in a handful
of elements (the round inputs differ in the last ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import layers as L
from repro_torch.models.transformer import PagedKVState, TransformerLM

pytestmark = pytest.mark.torch_port

PAGE, N_PAGES, MAX_PAGES, B = 4, 24, 8, 3


def t(a):
    return torch.from_numpy(np.array(a))


def perturbed(np_params, seed=0):
    """Random QKV biases and norm scales (JAX inits zeros and ones)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.array, np_params)
    blocks = out["blocks"]["sub0"]
    for name in ("bq", "bk", "bv"):
        a = blocks["attn"][name]
        blocks["attn"][name] = (0.1 * rng.standard_normal(a.shape)).astype(
            a.dtype)
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
    jcfg = jax_get_config("qwen2-7b", reduced=True)
    jm = jax_build_model(jcfg, remat=False)
    np_params = perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    cfg = get_config("qwen2-7b", reduced=True)
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(np_params, cfg, "cpu")
    return jm, jp, tm, tp, np_params


def prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    s = -(-max(lens) // PAGE) * PAGE
    toks = np.zeros((len(lens), s), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, np.asarray(lens, np.int32)


def page_table(lens, extra=2, seed=4):
    """Distinct frames per row covering each prompt plus ``extra`` tokens
    of decode growth; the last frame stays free (the decode scratch row)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N_PAGES - 1)
    table = np.full((len(lens), MAX_PAGES), -1, np.int32)
    for i, n in enumerate(lens):
        k = -(-(n + extra) // PAGE)
        table[i, :k] = perm[i * MAX_PAGES: i * MAX_PAGES + k]
    return table


def jax_state(jm, table):
    st = jm.init_kv_state(B, N_PAGES, PAGE, MAX_PAGES)
    return st._replace(page_table=jnp.asarray(table))


def torch_state(tm, table):
    st = tm.init_kv_state(B, N_PAGES, PAGE, MAX_PAGES)
    return st._replace(page_table=t(table))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class TestLayers:
    def test_bridge_unstacks_every_layer(self, models):
        _, _, tm, tp, np_params = models
        stacked = np_params["blocks"]["sub0"]
        assert len(tp["blocks"]) == tm.cfg.num_layers == 2
        for i, blk in enumerate(tp["blocks"]):
            np.testing.assert_array_equal(blk["attn"]["bq"].numpy(),
                                          stacked["attn"]["bq"][i])
            np.testing.assert_array_equal(blk["mlp"]["w_down"].numpy(),
                                          stacked["mlp"]["w_down"][i])
            np.testing.assert_array_equal(blk["ln2"]["scale"].numpy(),
                                          stacked["ln2"]["scale"][i])
        np.testing.assert_array_equal(tp["head"].numpy(), np_params["head"])

    def test_rmsnorm_rope_qkv_swiglu(self, models):
        _, _, tm, tp, np_params = models
        cfg = tm.cfg
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
        blk = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                     np_params["blocks"]["sub0"])
        tblk = tp["blocks"][0]
        np.testing.assert_allclose(
            L.rmsnorm(tblk["ln1"], t(x), cfg.norm_eps).numpy(),
            np.asarray(JL.rmsnorm(blk["ln1"], jnp.asarray(x), cfg.norm_eps)),
            atol=1e-5, rtol=1e-5)
        q, k, v = L.qkv_project(tblk["attn"], t(x), cfg)
        jq, jk, jv = JL.qkv_project(blk["attn"], jnp.asarray(x), cfg)
        for a, b in ((q, jq), (k, jk), (v, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
        pos = np.broadcast_to(np.arange(6) + 1000, (2, 6)).astype(np.int32)
        np.testing.assert_allclose(
            L.apply_rope(q, t(pos), cfg.rope_theta).numpy(),
            np.asarray(JL.apply_rope(jq, jnp.asarray(pos), cfg.rope_theta)),
            atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(
            L.swiglu(tblk["mlp"], t(x)).numpy(),
            np.asarray(JL.swiglu(blk["mlp"], jnp.asarray(x))),
            atol=1e-5, rtol=1e-5)

    def test_init_distributions(self):
        """The port's seeded init draws the JAX package's distributions:
        N(0, 1/d_in) weights, N(0, 0.02^2) embeddings, zero biases, unit
        norm scales — deterministic per seed."""
        cfg = get_config("qwen2-7b", reduced=True)
        m = build_model(cfg, device="cpu")
        p, p2 = m.init(0), m.init(0)
        torch.testing.assert_close(p["embed"], p2["embed"], atol=0, rtol=0)
        wq = p["blocks"][0]["attn"]["wq"]
        assert wq.shape == (cfg.d_model, cfg.num_heads * cfg.head_dim)
        assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 0.1
        assert abs(float(p["embed"].std()) / 0.02 - 1) < 0.1
        assert float(p["blocks"][1]["attn"]["bk"].abs().max()) == 0.0
        assert float(p["ln_f"]["scale"].min()) == 1.0


# ---------------------------------------------------------------------------
# serve paths
# ---------------------------------------------------------------------------


class TestServePaths:
    LENS = [13, 6, 9]

    def run_prefill(self, models, kv_dtype):
        jm, jp, tm, tp, _ = models
        if kv_dtype != "native":
            import copy
            jm = copy.copy(jm)
            jm.kv_dtype = kv_dtype
            tm = build_model(tm.cfg, device="cpu", kv_dtype=kv_dtype)
        toks, lens = prompts(tm.cfg.vocab_size, self.LENS)
        table = page_table(self.LENS)
        jl, js = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens),
                            jax_state(jm, table))
        tl, ts = tm.prefill(tp, t(toks), t(lens), torch_state(tm, table))
        return jm, jp, tm, tp, (jl, js), (tl, ts)

    def test_prefill_logits_and_pools(self, models):
        *_, (jl, js), (tl, ts) = self.run_prefill(models, "native")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        for a, b in ((ts.k_pools, js.k_pools), (ts.v_pools, js.v_pools)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
        np.testing.assert_array_equal(ts.seq_lens.numpy(), self.LENS)

    def test_decode_step_logits_and_pools(self, models):
        jm, jp, tm, tp, (jl, js), (tl, ts) = self.run_prefill(models,
                                                              "native")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        for _ in range(2):
            jl, js = jm.decode_step(jp, jnp.asarray(tok), js)
            tl, ts = tm.decode_step(tp, t(tok), ts)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=1e-4)
            np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                          np.asarray(js.seq_lens))
            tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        # the scratch frame (last) takes masked writes only; compare the rest
        for a, b in ((ts.k_pools, js.k_pools), (ts.v_pools, js.v_pools)):
            np.testing.assert_allclose(a.numpy()[:, :-1],
                                       np.asarray(b)[:, :-1], atol=1e-5,
                                       rtol=1e-5)

    def test_int8_pools_after_prefill_and_decode(self, models):
        jm, jp, tm, tp, (jl, js), (tl, ts) = self.run_prefill(models, "int8")
        assert ts.k_pools.dtype == torch.int8
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, js = jm.decode_step(jp, jnp.asarray(tok), js)
        tl, ts = tm.decode_step(tp, t(tok), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                                   rtol=1e-3)
        for a, b in ((ts.k_pools, js.k_pools), (ts.v_pools, js.v_pools)):
            diff = np.abs(a.numpy()[:, :-1].astype(np.int32)
                          - np.asarray(b)[:, :-1].astype(np.int32))
            assert diff.max() <= 1
            assert int((diff > 0).sum()) <= 8

    def test_inactive_lane_writes_scratch_row_and_freezes(self, models):
        """A lane with an unmapped table row writes the pool's last row and
        keeps its seq_lens (``transformer.py:603-621``)."""
        _, _, tm, tp, (_, _), (_, ts) = self.run_prefill(models, "native")
        before = ts.k_pools.clone()
        masked = ts.page_table.clone()
        masked[1] = -1
        tl, ns = tm.decode_step(tp, torch.zeros(B, dtype=torch.int32),
                                ts._replace(page_table=masked))
        assert int(ns.seq_lens[1]) == self.LENS[1]
        assert int(ns.seq_lens[0]) == self.LENS[0] + 1
        changed = (ts.k_pools != before).any(dim=(0, 2, 3, 4))
        frames = set(torch.nonzero(changed).flatten().tolist())
        live = {int(masked[0, self.LENS[0] // PAGE]),
                int(masked[2, self.LENS[2] // PAGE])}
        assert frames <= live | {N_PAGES - 1}
        assert N_PAGES - 1 in frames

    @pytest.mark.parametrize("kv_dtype", ["native", "int8"])
    def test_decode_multi_step_equals_chained_steps(self, models, kv_dtype):
        _, _, tm0, tp, *_ = models
        tm = build_model(tm0.cfg, device="cpu", kv_dtype=kv_dtype)
        toks, lens = prompts(tm.cfg.vocab_size, self.LENS)
        table = page_table(self.LENS, extra=6)
        steps_left = torch.tensor([5, 2, 0], dtype=torch.int32)

        def prefilled():
            logits, st = tm.prefill(tp, t(toks), t(lens),
                                    torch_state(tm, table))
            return logits.argmax(-1).to(torch.int32), st

        first, st = prefilled()
        block, fused = tm.decode_multi_step(
            tp, first, st, steps_left, None, 1.0, horizon=5, greedy=True)
        first, st = prefilled()
        tok, rows = first, []
        for step in range(5):
            active = step < steps_left
            masked = torch.where(active[:, None], st.page_table, -1)
            logits, ns = tm.decode_step(tp, tok,
                                        st._replace(page_table=masked))
            new = logits.argmax(-1).to(torch.int32)
            tok = torch.where(active, new, tok)
            st = st._replace(seq_lens=ns.seq_lens)
            rows.append(new)
        for step in range(5):
            for lane in range(B):
                if step < int(steps_left[lane]):
                    assert int(block[step, lane]) == int(rows[step][lane])
        np.testing.assert_array_equal(fused.seq_lens.numpy(),
                                      st.seq_lens.numpy())
        np.testing.assert_array_equal(fused.seq_lens.numpy(),
                                      np.asarray(self.LENS) + [5, 2, 0])

    def test_decode_multi_step_matches_jax(self, models):
        jm, jp, tm, tp, (jl, js), (tl, ts) = self.run_prefill(models,
                                                              "native")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        steps = np.asarray([2, 2, 1], np.int32)
        jblock, js, _ = jm.decode_multi_step(
            jp, jnp.asarray(tok), js, jnp.asarray(steps),
            jax.random.PRNGKey(0), jnp.float32(1.0), horizon=2, greedy=True)
        tblock, ts = tm.decode_multi_step(tp, t(tok), ts, t(steps), None,
                                          1.0, horizon=2, greedy=True)
        jb = np.asarray(jblock)
        for step in range(2):
            for lane in range(B):
                if step < steps[lane]:
                    assert int(tblock[step, lane]) == int(jb[step, lane])
        np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                      np.asarray(js.seq_lens))


def test_non_dense_family_names_its_slice():
    """Every family builds: RG-LRU as a ``RecurrentGemmaLM`` (which
    ``TransformerLM`` refuses, naming it), the VLM and audio families as
    ``TransformerLM``s."""
    cfg = get_config("recurrentgemma-9b", reduced=True)
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == "RecurrentGemmaLM"
    assert model.cfg.family == "hybrid_rglru"
    with pytest.raises(NotImplementedError, match="RecurrentGemmaLM"):
        TransformerLM(cfg, device="cpu")
    for arch, family in (("qwen2-vl-7b", "vlm"), ("musicgen-large", "audio")):
        model = build_model(get_config(arch, reduced=True), device="cpu")
        assert type(model).__name__ == "TransformerLM"
        assert model.cfg.family == family


def test_paged_state_layout(models):
    _, _, tm, _, _ = models
    st = tm.init_kv_state(B, N_PAGES, PAGE, MAX_PAGES)
    assert isinstance(st, PagedKVState)
    assert st.k_pools.shape == (2, N_PAGES, PAGE, 2, 14)
    assert st.page_size == PAGE
    assert st.page_table.dtype == torch.int32
    assert int(st.page_table.max()) == -1
