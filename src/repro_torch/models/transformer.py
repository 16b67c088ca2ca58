"""Decoder-only dense GQA transformer LM — the serve paths, in PyTorch.

Port of the dense family of ``src/repro/models/transformer.py``:
  * params are plain dicts of tensors; the JAX package stacks the repeated
    block along a leading layer axis (``params["blocks"]["sub0"]``), the
    port keeps one dict per layer (``params["blocks"][i]``) and loops in
    Python — :func:`params_from_jax` unstacks;
  * weights keep the JAX ``[in, out]`` layout and are applied as ``x @ W``
    (no transpose in the bridge);
  * serving reads/writes the KV cache through the paged virtual-memory
    subsystem: prefill writes KV with one translation per page burst
    (``paged_copy``) and attends within the chunk (``flash_attention``),
    decode attends through the page table (``paged_decode_attention``);
  * the KV pools are updated IN PLACE (JAX returns new, donated pools);
    every serve entry point returns the state it was given, with new
    ``seq_lens``.

Every tensor lives on ``self.device``: ``cuda`` unless the caller passes
``device="cpu"`` (the kernels' plain versions then run).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.vmem import INVALID_PAGE
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]


class PagedKVState(NamedTuple):
    """Serving-side state: paged KV pools + the page table ("satp")."""

    k_pools: torch.Tensor     # [L, P, page, Hkv, hd]
    v_pools: torch.Tensor     # [L, P, page, Hkv, hd]
    page_table: torch.Tensor  # [B, max_pages] int32
    seq_lens: torch.Tensor    # [B] int32 — tokens currently in cache

    @property
    def page_size(self) -> int:
        return self.k_pools.shape[2]


class TransformerLM:
    """Dense GQA transformer (the ``dense`` family) on one device."""

    KV_INT8_SCALE = 24.0  # fixed-point scale (values are post-norm, O(1))

    def __init__(self, cfg: ModelConfig, *, device=None,
                 use_kernels: bool = True, kv_dtype: str = "native"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: the MoE, VLM and "
                "audio families, RG-LRU and RWKV-6 come in later slices of "
                "the PyTorch port (ROADMAP.md)")
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype must be 'native' or 'int8', got "
                             f"{kv_dtype!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: False routes every kernel call to its plain version even on the
        #: card (the explicit escape hatch, ``ServeConfig.use_ref_path``)
        self.use_kernels = use_kernels
        self.kv_dtype = kv_dtype
        self.dtype = L.DTYPES[cfg.param_dtype]

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def init(self, seed: int) -> Params:
        """Random weights from a seeded ``torch.Generator`` on the device,
        with the JAX package's distributions (not its numbers)."""
        cfg, dt = self.cfg, self.dtype
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        blocks = []
        for _ in range(cfg.num_layers):
            blocks.append({
                "ln1": L.rmsnorm_init(cfg.d_model, dt, self.device),
                "attn": L.attention_init(gen, cfg, dt),
                "ln2": L.rmsnorm_init(cfg.d_model, dt, self.device),
                "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt),
            })
        p: Params = {
            "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "blocks": blocks,
            "ln_f": L.rmsnorm_init(cfg.d_model, dt, self.device),
        }
        if not cfg.tie_embeddings:
            p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
        return p

    # ------------------------------------------------------------------
    # embedding / logits
    # ------------------------------------------------------------------

    def embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def logits_fn(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return h @ params["head"]

    # ------------------------------------------------------------------
    # serving: prefill + paged decode
    # ------------------------------------------------------------------

    def _kv_store_dtype(self):
        return torch.int8 if self.kv_dtype == "int8" else self.dtype

    def _kv_scale(self) -> float | None:
        return 1.0 / self.KV_INT8_SCALE if self.kv_dtype == "int8" else None

    def _kv_quant(self, x: torch.Tensor) -> torch.Tensor:
        if self.kv_dtype != "int8":
            return x
        return torch.clamp(torch.round(x.float() * self.KV_INT8_SCALE),
                           -127, 127).to(torch.int8)

    def init_kv_state(self, batch: int, num_pages: int, page_size: int,
                      max_pages: int) -> PagedKVState:
        cfg, dev = self.cfg, self.device
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        return PagedKVState(
            k_pools=torch.zeros(shape, dtype=self._kv_store_dtype(),
                                device=dev),
            v_pools=torch.zeros(shape, dtype=self._kv_store_dtype(),
                                device=dev),
            page_table=torch.full((batch, max_pages), INVALID_PAGE,
                                  dtype=torch.int32, device=dev),
            seq_lens=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )

    def _rope(self, positions: torch.Tensor):
        """RoPE tables for ``positions``, computed once per serve call."""
        return L.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)

    def _block_serve_qkv(self, p, x, rope):
        """Shared q/k/v + rope for serve paths. x [B, T, D]."""
        cfg = self.cfg
        q, k, v = L.qkv_project(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                cfg)
        return L.rotate(q, *rope), L.rotate(k, *rope), v

    def _ffn_serve(self, p, x):
        return x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, self.cfg.norm_eps))

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                prompt_lens: torch.Tensor, state: PagedKVState
                ) -> tuple[torch.Tensor, PagedKVState]:
        """Run padded prompts ``tokens [B, S]`` (true lengths
        ``prompt_lens [B]`` int32), write KV through the page table (burst
        copies, in place).  Returns (last-token logits [B, V], state with
        seq_lens = prompt_lens)."""
        cfg = self.cfg
        b, s = tokens.shape[:2]
        page = state.page_size
        hkv, hd = cfg.num_kv_heads, cfg.head_dim
        rope = self._rope(torch.arange(s, device=tokens.device).expand(b, s))
        x = self.embed(params, tokens)
        for li, block_p in enumerate(params["blocks"]):
            q, k, v = self._block_serve_qkv(block_p, x, rope)
            # unit-stride burst write through the page table (C2-burst);
            # the pool stores its own dtype (quantized under int8), the
            # chunk's own attention below keeps the raw activations
            for t, pools in ((k, state.k_pools), (v, state.v_pools)):
                ops.paged_copy(
                    self._kv_quant(t).reshape(b, s, hkv * hd),
                    pools[li].view(-1, page, hkv * hd),
                    state.page_table, prompt_lens, page_size=page,
                    use_kernel=self.use_kernels,
                )
            o = ops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, use_kernel=self.use_kernels,
            )                                         # [B, Hq, S, hd]
            x = x + o.transpose(1, 2).reshape(b, s, -1) @ block_p["attn"]["wo"]
            x = self._ffn_serve(block_p, x)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        last_idx = (prompt_lens.long() - 1).clamp(min=0)
        last = x[torch.arange(b, device=x.device), last_idx]
        logits = self.logits_fn(params, last)
        return logits, state._replace(seq_lens=prompt_lens.to(torch.int32))

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: torch.Tensor,
                    state: PagedKVState) -> tuple[torch.Tensor, PagedKVState]:
        """One token: write KV at position seq_lens, attend through pages.

        The host must already have mapped a page covering position
        ``seq_lens``.  Inactive batch slots (unmapped page-table rows) write
        to the pool's LAST row, which the engine reserves as scratch, and
        keep their ``seq_lens``."""
        cfg = self.cfg
        b = tokens.shape[0]
        page = state.page_size
        hkv, hd, g = cfg.num_kv_heads, cfg.head_dim, cfg.q_per_kv
        max_pages = state.page_table.shape[1]
        pos = state.seq_lens                          # [B] position of new token
        x = self.embed(params, tokens)[:, None, :]    # [B, 1, D]
        vpn = (pos // page).long()
        frames = state.page_table[:b].gather(
            1, vpn.clamp(max=max_pages - 1)[:, None])[:, 0]
        frames = torch.where(vpn < max_pages, frames, INVALID_PAGE)
        n_rows = state.k_pools.shape[1] * page
        rows = torch.where(frames < 0, n_rows - 1,
                           frames * page + pos % page).long()     # [B]
        new_lens = torch.where(frames < 0, pos, pos + 1).to(torch.int32)
        kv_scale = self._kv_scale()
        rope = self._rope(pos[:, None])
        for li, block_p in enumerate(params["blocks"]):
            q, k, v = self._block_serve_qkv(block_p, x, rope)
            # the single-token row scatter is a plain index_put_
            state.k_pools[li].view(-1, hkv, hd)[rows] = self._kv_quant(k[:, 0])
            state.v_pools[li].view(-1, hkv, hd)[rows] = self._kv_quant(v[:, 0])
            o = ops.paged_decode_attention(
                q[:, 0].reshape(b, hkv, g, hd), state.k_pools[li],
                state.v_pools[li], state.page_table, new_lens,
                page_size=page, kv_scale=kv_scale,
                use_kernel=self.use_kernels,
            )                                          # [B, Hkv, G, hd]
            x = x + o.reshape(b, 1, hkv * g * hd) @ block_p["attn"]["wo"]
            x = self._ffn_serve(block_p, x)
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = self.logits_fn(params, x[:, 0])
        return logits, state._replace(seq_lens=new_lens)

    @torch.no_grad()
    def decode_multi_step(
        self, params: Params, tokens: torch.Tensor, state: PagedKVState,
        steps_left: torch.Tensor, gen: torch.Generator | None,
        temperature: float, *, horizon: int, greedy: bool,
    ) -> tuple[torch.Tensor, PagedKVState]:
        """Fused K-token decode: ``horizon`` chained :meth:`decode_step`
        calls with ON-DEVICE sampling (greedy argmax, or temperature
        sampling drawn from ``gen`` exactly as :func:`sample` does on the
        host path, one draw per step, so fused and step-wise stochastic
        streams are identical).

        Lane ``i`` is active at inner step ``t`` iff ``t < steps_left[i]``;
        inactive lanes get their page-table row masked to the invalid
        sentinel, which routes their KV write to the scratch row and
        freezes their ``seq_lens``.  Returns ``(token_block [horizon, B],
        state)``; block rows at ``t >= steps_left[i]`` are scratch."""
        ptab = state.page_table
        toks, seq_lens = tokens, state.seq_lens
        block = []
        for t in range(horizon):
            active = t < steps_left                            # [B] bool
            masked = torch.where(active[:, None], ptab, INVALID_PAGE)
            logits, ns = self.decode_step(
                params, toks, state._replace(page_table=masked,
                                             seq_lens=seq_lens))
            new_tok = sample(logits, gen, temperature, greedy).to(toks.dtype)
            toks = torch.where(active, new_tok, toks)
            seq_lens = ns.seq_lens
            block.append(new_tok)
        return torch.stack(block), state._replace(seq_lens=seq_lens)


def sample(logits: torch.Tensor, gen: torch.Generator | None,
           temperature: float, greedy: bool) -> torch.Tensor:
    """Next token per row: argmax, or a Gumbel-max draw from
    ``softmax(logits / temperature)`` with one ``torch.rand`` from ``gen``
    (the JAX package's ``jax.random.categorical`` draws differently)."""
    if greedy:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return (logits.float() / temperature + gumbel).argmax(dim=-1)


def params_from_jax(np_params: Params, cfg: ModelConfig, device) -> Params:
    """Bridge: the JAX ``TransformerLM.init`` pytree (as numpy arrays) to
    the port's parameters on ``device``.

    The JAX pytree stacks each block leaf along a leading layer axis under
    ``params["blocks"]["sub0"]``; the port keeps one dict per layer.
    Weights keep their ``[in, out]`` layout.  Dense family only."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else t(v[i])
                for k, v in tree.items()}

    stacked = np_params["blocks"]["sub0"]
    out: Params = {
        "embed": t(np_params["embed"]),
        "blocks": [layer(stacked, i) for i in range(cfg.num_layers)],
        "ln_f": {"scale": t(np_params["ln_f"]["scale"])},
    }
    if "head" in np_params:
        out["head"] = t(np_params["head"])
    return out
