"""RecurrentGemma / Griffin hybrid — RG-LRU recurrent blocks and local
attention — the serve path, in PyTorch.

Port of ``src/repro/models/rglru.py`` (``init``, ``forward``, ``loss``,
``init_state``, ``prefill``, ``decode_step``):
  * layers follow ``cfg.block_pattern`` cyclically (recurrentgemma-9b:
    (recurrent, recurrent, local attention) x 12 and two recurrent tail
    layers, 38 in all);
  * recurrent block: ``x -> [gelu(W_gate x)] * [RG-LRU(conv1d_4(W_x x))]
    -> W_out`` and a SwiGLU MLP; the RG-LRU's gates and decay are f32
    (``r = sig(W_r x)``, ``i = sig(W_i x)``, ``a = exp(-8 softplus(lam)
    r)``, ``bx = sqrt(1 - a^2) (i x)``) and, with the recurrence ``h_t =
    a_t h_{t-1} + bx_t``, one :func:`repro_torch.kernels.ops.rglru` a layer
    and call (JAX: XLA and ``jax.lax.associative_scan``);
  * local attention: MQA (one KV head) with a sliding window
    (``cfg.local_window``) over the paged KV cache: prefill writes K and V
    through the page table in one launch (``paged_copy_kv``) and attends
    within the prompt with the plain windowed ``chunked_attention_ref``
    (plain in JAX too); decode writes one row a sequence and attends
    through the page table (``paged_decode_attention`` with the window);
  * params are plain dicts of tensors, one dict per layer
    (``params["layers"][i]``, a recurrent or an attention layer as the
    pattern says; the JAX pytree stacks them as ``supers.rec0`` /
    ``supers.rec1`` / ``supers.attn`` and ``tail`` —
    :func:`params_from_jax` unstacks), weights in the JAX ``[in, out]``
    layout applied as ``x @ W``; ``lam`` is f32 in a bf16 model;
  * the serve calls update the KV pools IN PLACE (as ``TransformerLM``
    does; JAX returns new pools) and return new recurrent slabs
    (``rg_h``, ``conv_buf``): the given state's slabs are not changed;
  * training (``forward``, ``loss``) runs every layer from a zero state
    under autograd: the RG-LRU through ``ops.rglru`` (its plain version
    under ``use_kernels=False``; the kernel has no backward and refuses
    inputs that require grad under grad mode), the local attention
    through ``layers.attention_train`` with the window, hence always the
    flash-backward ``chunked_attention_flashbwd_ref``.

JAX's prefill is kept as it is: the recurrence runs over all T columns of
the padded batch and the carried state is ``h`` and the conv tail at the
padded width, exact only for equal prompt lengths.

Every tensor lives on ``self.device``: ``cuda`` unless the caller passes
``device="cpu"`` (the kernels' plain versions then run).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.vmem import INVALID_PAGE
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]
CONV_WIDTH = 4


class HybridState(NamedTuple):
    """Serving state: recurrent slabs + paged KV for the attention layers."""

    rg_h: torch.Tensor        # [n_rec, B, R] f32   RG-LRU hidden state
    conv_buf: torch.Tensor    # [n_rec, B, CONV_WIDTH - 1, R] causal conv tail
    k_pools: torch.Tensor     # [n_att, P, page, 1, hd]
    v_pools: torch.Tensor     # [n_att, P, page, 1, hd]
    page_table: torch.Tensor  # [B, max_pages] int32
    seq_lens: torch.Tensor    # [B] int32

    @property
    def page_size(self) -> int:
        return self.k_pools.shape[2]


class RecurrentGemmaLM:
    """The ``hybrid_rglru`` family on one device."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 use_kernels: bool = True, remat: bool = True, shard=None):
        if cfg.family != "hybrid_rglru":
            raise ValueError(f"RecurrentGemmaLM serves the hybrid_rglru "
                             f"family, got {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: False routes the RG-LRU, the copies and the decode attention to
        #: their plain versions even on the card (JAX's ``use_kernels``)
        self.use_kernels = use_kernels
        #: activation checkpointing under grad of each superblock and each
        #: tail layer (JAX's ``jax.checkpoint`` of its two scan bodies)
        self.remat = remat
        #: the activation hook ``shard(x, name)`` at JAX's sites
        self.shard = shard or L.no_shard
        self.dtype = L.DTYPES[cfg.param_dtype]
        self.pattern = cfg._full_pattern()
        n_super = cfg.num_layers // len(cfg.block_pattern)
        if any(k != "rglru" for k in self.pattern[n_super
                                                  * len(cfg.block_pattern):]):
            raise ValueError("tail layers must be recurrent (the pattern "
                             "starts with rglru)")
        self.n_rec = sum(k == "rglru" for k in self.pattern)
        self.n_att = len(self.pattern) - self.n_rec

    @property
    def rdim(self) -> int:
        return self.cfg.rglru_dim or self.cfg.d_model

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def _init_recurrent(self, gen: torch.Generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        d, r = cfg.d_model, self.rdim
        return {
            "ln": L.rmsnorm_init(d, dt, dev),
            "w_gate": L.dense_init(gen, d, r, dt),
            "w_x": L.dense_init(gen, d, r, dt),
            "conv_w": (torch.randn((CONV_WIDTH, r), generator=gen,
                                   dtype=torch.float32, device=dev)
                       * 0.1).to(dt),
            "w_r": L.dense_init(gen, r, r, dt),
            "w_i": L.dense_init(gen, r, r, dt),
            "lam": 0.4 + 0.4 * torch.rand((r,), generator=gen,
                                          dtype=torch.float32, device=dev),
            "w_out": L.dense_init(gen, r, d, dt),
            "ln2": L.rmsnorm_init(d, dt, dev),
            "mlp": L.swiglu_init(gen, d, cfg.d_ff, dt),
        }

    def _init_attention(self, gen: torch.Generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {
            "ln": L.rmsnorm_init(cfg.d_model, dt, dev),
            "attn": L.attention_init(gen, cfg, dt),
            "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
            "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt),
        }

    def init(self, seed: int) -> Params:
        """Random weights from a seeded ``torch.Generator`` on the device,
        with the JAX package's distributions (not its numbers): ``lam``
        uniform in [0.4, 0.8) in f32, ``conv_w`` normal x 0.1."""
        cfg, dt = self.cfg, self.dtype
        gen = L.generator(self.device, seed)
        return {
            "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "layers": [self._init_recurrent(gen) if kind == "rglru"
                       else self._init_attention(gen)
                       for kind in self.pattern],
            "ln_f": L.rmsnorm_init(cfg.d_model, dt, self.device),
            "head": L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
        }

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------

    def _recurrent_block(self, p: Params, x: torch.Tensor, h0: torch.Tensor,
                         conv_buf: torch.Tensor):
        """x [B, T, D]; h0 [B, R] f32; conv_buf [B, CONV_WIDTH - 1, R].
        Returns (out, h after the last column, new conv tail)."""
        cfg = self.cfg
        t = x.shape[1]
        xn = L.rmsnorm(p["ln"], x, cfg.norm_eps)
        gate = L.gelu(xn @ p["w_gate"])                       # [B, T, R]
        u = xn @ p["w_x"]                                      # [B, T, R]
        # causal conv over time (width 4) in the param dtype, carrying the
        # previous tail; summed in JAX's order (0 + tap 0 + ... + tap 3)
        u_ext = torch.cat([conv_buf.to(u.dtype), u], dim=1)
        conv = sum(u_ext[:, i:i + t] * p["conv_w"][i]
                   for i in range(CONV_WIDTH))
        new_conv_buf = u_ext[:, -(CONV_WIDTH - 1):]
        # RG-LRU in f32: gates, decay and recurrence in one call
        h = ops.rglru(conv, p["w_r"], p["w_i"], p["lam"],
                      h0.float().contiguous(), use_kernel=self.use_kernels)
        x = x + (gate * h.to(gate.dtype)) @ p["w_out"]
        x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
        return x, h[:, -1], new_conv_buf

    def _attention_block(self, p: Params, x: torch.Tensor, k_pool, v_pool,
                         state: HybridState, rope, kv_lens, prompt_lens,
                         rows):
        """x [B, T, D].  T > 1 (a prefill): K and V of the prompt through
        the page table in one launch, windowed causal attention within the
        prompt.  T = 1 (a decode step, or a one-token prefill, as in JAX):
        one K and V row a sequence at ``rows`` (``index_put_``), windowed
        attention through the pages."""
        cfg = self.cfg
        b, t, _ = x.shape
        hkv, hd, g = cfg.num_kv_heads, cfg.head_dim, cfg.q_per_kv
        page = state.page_size
        q, k, v = L.qkv_project(p["attn"], L.rmsnorm(p["ln"], x,
                                                     cfg.norm_eps), cfg)
        q, k = L.rotate(q, *rope), L.rotate(k, *rope)
        if rows is None:
            ops.paged_copy_kv(
                k.reshape(b, t, hkv * hd), v.reshape(b, t, hkv * hd),
                k_pool.view(-1, page, hkv * hd),
                v_pool.view(-1, page, hkv * hd), state.page_table,
                prompt_lens, page_size=page, use_kernel=self.use_kernels)
            o = ref.chunked_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=cfg.local_window)     # [B, Hq, T, hd]
            o = o.transpose(1, 2).reshape(b, t, -1)
        else:
            k_pool.view(-1, hkv, hd)[rows] = k[:, 0]
            v_pool.view(-1, hkv, hd)[rows] = v[:, 0]
            o = ops.paged_decode_attention(
                q[:, 0].reshape(b, hkv, g, hd), k_pool, v_pool,
                state.page_table, kv_lens, page_size=page,
                window=cfg.local_window, use_kernel=self.use_kernels,
            ).reshape(b, 1, hkv * g * hd)
        x = x + o @ p["attn"]["wo"]
        return x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))

    def _attention_block_train(self, p: Params, x: torch.Tensor,
                               positions: torch.Tensor) -> torch.Tensor:
        """A local attention layer of the training forward (JAX
        ``rglru.py:195-201``)."""
        cfg = self.cfg
        x = x + L.attention_train(
            p["attn"], L.rmsnorm(p["ln"], x, cfg.norm_eps), positions, cfg,
            window=cfg.local_window)
        return x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))

    # ------------------------------------------------------------------
    # training forward
    # ------------------------------------------------------------------

    def _layers_train(self, first: int, layers: list, x: torch.Tensor,
                      positions: torch.Tensor, h0: torch.Tensor,
                      conv0: torch.Tensor) -> torch.Tensor:
        """The training forward of the layers ``first, first + 1, ...``: a
        superblock (``rec0, rec1, attn``) or one tail layer, the bodies of
        JAX's two scans (``rglru.py:223-247``); the activation hook at
        a superblock's start, as there."""
        n = len(self.cfg.block_pattern)
        if first < len(self.pattern) // n * n:
            x = self.shard(x, "act_btd")
        for kind, p in zip(self.pattern[first:], layers):
            if kind == "rglru":
                x = self._recurrent_block(p, x, h0, conv0)[0]
            else:
                x = self._attention_block_train(p, x, positions)
        return x

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """The training forward of ``tokens [B, T]`` from a zero state (JAX
        ``rglru.py:207-250``, tail layers included): the final-norm hidden
        states ``[B, T, D]``.  Under grad mode with ``remat`` each
        superblock and each tail layer is checkpointed."""
        cfg = self.cfg
        b, t = tokens.shape
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = params["embed"][tokens.long()]
        h0 = torch.zeros((b, self.rdim), dtype=torch.float32,
                         device=x.device)
        conv0 = torch.zeros((b, CONV_WIDTH - 1, self.rdim), dtype=self.dtype,
                            device=x.device)
        n = len(cfg.block_pattern)
        supers = len(self.pattern) // n * n      # layers in superblocks
        spans = ([(i, i + n) for i in range(0, supers, n)]
                 + [(i, i + 1) for i in range(supers, len(self.pattern))])
        for first, end in spans:
            x = L.remat_apply(self.remat, self._layers_train, first,
                              params["layers"][first:end], x, positions, h0,
                              conv0)
        return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)

    def loss(self, params: Params, batch: dict[str, torch.Tensor]):
        """Mean cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (``batch["mask"]`` optional); returns (xent,
        {"xent", "aux": 0})."""
        h = self.forward(params, batch["tokens"])
        xent = L.softmax_xent(self.shard(h @ params["head"], "logits"),
                              batch["labels"], batch.get("mask"))
        return xent, {"xent": xent, "aux": xent.new_zeros(())}

    @staticmethod
    def _kv_rows(state: HybridState, pos: torch.Tensor) -> torch.Tensor:
        """The flat pool row of each sequence's position ``pos [B]``, as
        JAX's gather finds it: a position past the table, or on an
        unmapped page, writes the pool's last row (the reserved scratch);
        position -1 (an empty row of a one-token prefill) wraps to the
        last row of the table's last page."""
        page = state.page_size
        max_pages = state.page_table.shape[1]
        vpn = (pos // page).long()
        vpn = torch.where(vpn < 0, vpn + max_pages, vpn)
        frames = state.page_table[:pos.shape[0]].gather(
            1, vpn.clamp(0, max_pages - 1)[:, None])[:, 0]
        frames = torch.where((vpn >= 0) & (vpn < max_pages), frames,
                             INVALID_PAGE)
        n_rows = state.k_pools.shape[1] * page
        return torch.where(frames < 0, n_rows - 1,
                           frames * page + pos % page).long()

    def _serve_pass(self, params: Params, x: torch.Tensor,
                    state: HybridState, positions: torch.Tensor,
                    kv_lens: torch.Tensor, prompt_lens=None):
        """The layer sweep shared by prefill and decode, branching as
        JAX's on T: T = 1 writes one K/V row at ``kv_lens - 1``.  Returns
        (the final-norm hidden states, the new state)."""
        cfg = self.cfg
        rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        rows = (self._kv_rows(state, kv_lens - 1) if x.shape[1] == 1
                else None)
        rg_h, conv_buf = [], []
        att_i = 0
        for kind, p in zip(self.pattern, params["layers"]):
            if kind == "rglru":
                rec_i = len(rg_h)
                x, h_fin, cb = self._recurrent_block(
                    p, x, state.rg_h[rec_i], state.conv_buf[rec_i])
                rg_h.append(h_fin)
                conv_buf.append(cb)
            else:
                x = self._attention_block(
                    p, x, state.k_pools[att_i], state.v_pools[att_i], state,
                    rope, kv_lens, prompt_lens, rows)
                att_i += 1
        new_state = state._replace(rg_h=torch.stack(rg_h),
                                   conv_buf=torch.stack(conv_buf),
                                   seq_lens=kv_lens.to(torch.int32))
        return L.rmsnorm(params["ln_f"], x, cfg.norm_eps), new_state

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def init_state(self, batch: int, num_pages: int, page_size: int,
                   max_pages: int) -> HybridState:
        cfg, dev, r = self.cfg, self.device, self.rdim
        pool = (self.n_att, num_pages, page_size, cfg.num_kv_heads,
                cfg.head_dim)
        return HybridState(
            rg_h=torch.zeros((self.n_rec, batch, r), dtype=torch.float32,
                             device=dev),
            conv_buf=torch.zeros((self.n_rec, batch, CONV_WIDTH - 1, r),
                                 dtype=self.dtype, device=dev),
            k_pools=torch.zeros(pool, dtype=self.dtype, device=dev),
            v_pools=torch.zeros(pool, dtype=self.dtype, device=dev),
            page_table=torch.full((batch, max_pages), INVALID_PAGE,
                                  dtype=torch.int32, device=dev),
            seq_lens=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                prompt_lens: torch.Tensor, state: HybridState
                ) -> tuple[torch.Tensor, HybridState]:
        """Run padded prompts ``tokens [B, T]`` (true lengths
        ``prompt_lens [B]`` int32) from position 0, continuing the
        recurrent slabs of ``state`` and writing K/V through its page
        table (in place).  A one-token prompt (T = 1) takes the decode's
        attention, as JAX's does: one K/V row at ``prompt_lens - 1`` and
        the paged windowed attention.  Returns (last-token logits [B, V],
        state with seq_lens = prompt_lens)."""
        b, t = tokens.shape
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        lens = prompt_lens.to(torch.int32)
        h, new_state = self._serve_pass(
            params, params["embed"][tokens.long()], state, positions, lens,
            prompt_lens=lens)
        last_idx = (lens.long() - 1).clamp(min=0)
        last = h[torch.arange(b, device=h.device), last_idx]
        return last @ params["head"], new_state

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: torch.Tensor,
                    state: HybridState) -> tuple[torch.Tensor, HybridState]:
        """One token a row at position ``seq_lens``: tokens [B] ->
        (logits [B, V], state with seq_lens + 1).  The host must have
        mapped a page covering that position; a row whose page is
        unmapped writes its K/V to the pool's last row (reserved
        scratch)."""
        pos = state.seq_lens                            # new token position
        h, new_state = self._serve_pass(
            params, params["embed"][tokens.long()][:, None, :], state,
            pos[:, None], pos + 1)
        return h[:, 0] @ params["head"], new_state


def params_from_jax(np_params: Params, cfg: ModelConfig, device) -> Params:
    """Bridge: the JAX ``RecurrentGemmaLM.init`` pytree (as numpy arrays)
    to the port's parameters on ``device``.  JAX stacks the repeated
    superblock's layers along a leading axis (``supers.rec0``,
    ``supers.rec1``, ``supers.attn``) and the recurrent tail apart
    (``tail``); recurrent layer ``rec_i`` of the supers is
    ``supers.rec{rec_i % n}[rec_i // n]`` (``n`` recurrent layers a
    superblock) and tail layer ``li`` is ``tail[li - n_super * len]``, as
    in JAX's ``_serve_pass``.  The port keeps one dict per layer, in the
    pattern's order; layouts and dtypes are kept."""
    if cfg.family != "hybrid_rglru":
        raise ValueError(f"not a hybrid_rglru config: {cfg.family!r}")
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else t(v[i])
                for k, v in tree.items()}

    plen = len(cfg.block_pattern)
    n_super_layers = cfg.num_layers // plen * plen
    n_rec_super = sum(k == "rglru" for k in cfg.block_pattern)
    supers = np_params["supers"]
    layers, rec_i, att_i = [], 0, 0
    for li, kind in enumerate(cfg._full_pattern()):
        if kind != "rglru":
            layers.append(layer(supers["attn"], att_i))
            att_i += 1
            continue
        if li < n_super_layers:
            si, pi = divmod(rec_i, n_rec_super)
            layers.append(layer(supers[f"rec{pi}"], si))
        else:
            layers.append(layer(np_params["tail"], li - n_super_layers))
        rec_i += 1
    return {
        "embed": t(np_params["embed"]),
        "layers": layers,
        "ln_f": {"scale": t(np_params["ln_f"]["scale"])},
        "head": t(np_params["head"]),
    }
