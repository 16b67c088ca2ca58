"""Decoder-only GQA transformer LM (dense, MoE, VLM and audio) — the
training forward and loss and the serve paths, in PyTorch.

Port of the dense, MoE, VLM and audio families of
``src/repro/models/transformer.py``:
  * params are plain dicts of tensors; the JAX package stacks the repeated
    superblock of ``moe_every`` layers along a leading axis
    (``params["blocks"]["sub0" | "sub1"]``), the port keeps one dict per
    layer (``params["blocks"][i]``, layer ``i`` being ``sub{i % m}[i //
    m]``) and loops in Python — :func:`params_from_jax` unstacks;
  * MoE (``moe.py``): the last layer of each superblock routes, the others
    are dense (llama4's ``moe_every = 2`` interleave; granite-moe routes in
    every layer); a serve call of at most 2,048 tokens dispatches
    drop-free through the grouped-product kernel, a longer one per row
    with capacity factor 2.0 (JAX's rule, decided by the static shapes, so
    per captured program);
  * VLM (qwen2-vl): M-RoPE, whose three position streams are identical on
    the serve paths (text positions), and a stub vision front end:
    ``prefill`` takes precomputed patch embeddings (``vision_embeds``)
    that overwrite the first positions of the embedded prompt;
  * audio (musicgen): tokens ``[..., K]`` over K EnCodec codebooks, a
    per-codebook embedding summed over the codebooks and a per-codebook
    head, so logits are ``[..., K, V]`` and a decode lane samples K tokens;
  * weights keep the JAX ``[in, out]`` layout and are applied as ``x @ W``
    (no transpose in the bridge);
  * serving reads/writes the KV cache through the paged virtual-memory
    subsystem: prefill writes a layer's K and V in one launch, one
    translation per page burst (``paged_copy_kv``), and attends within the
    chunk (``flash_attention``); continuation prefill writes at an
    arbitrary logical offset (``paged_copy_kv_at``) and attends over cache
    plus chunk through the page table (``paged_prefill_attention``);
    decode attends through the page table (``paged_decode_attention``);
  * the KV pools are updated IN PLACE (JAX returns new, donated pools);
    every serve entry point returns the state it was given, with new
    ``seq_lens``;
  * training (``forward``, ``loss``) runs under autograd: attention by
    ``layers.attention_train``, MoE layers by the dispatch
    ``moe_dispatch`` names (``"sorted"``: per row, capacity factor
    ``capacity_factor``, drops; ``"ragged"``; ``"dense"``), the router's
    load-balance loss summed over a superblock's layers, averaged over
    superblocks and added at 0.01.  A hand-written kernel has no backward:
    a model that trains is built with ``use_kernels=False``, as JAX's
    trainer builds its own; with ``use_kernels=True`` a grad-enabled loss
    raises in ``ops`` and a no-grad one runs the kernels.  ``remat``
    (JAX's default, True) checkpoints each superblock under grad mode
    (``layers.remat_apply``): its activations are recomputed in the
    backward; ``remat_policy="dots"`` keeps its matmul outputs (a
    selective checkpoint).

Every tensor lives on ``self.device``: ``cuda`` unless the caller passes
``device="cpu"`` (the kernels' plain versions then run).

With ``kernel_mesh``, a ('kv', 'hd') ``DeviceMesh`` of more than one rank
(``launch.mesh``), each rank runs the serve paths: the KV pools are
DTensors split over (kv, hd), every other tensor (weights, page table,
lengths, activations, logits) is replicated, and the five serve kernels
run on each rank's slice through ``ops.*_sharded`` (JAX's shard_map
dispatch, ``src/repro/models/transformer.py:288-296``).  What GSPMD does
implicitly in JAX is explicit here: the attention output, split over kv,
is all-gathered before the replicated ``wo``, and the decode step's row
scatter writes each rank's (kv, hd) slice of the new K/V into its pool
slice.  Unlike JAX, ``use_kernels=False`` keeps the mesh: the plain
versions run on each slice through the same wrappers.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.vmem import INVALID_PAGE
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
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


#: serve calls of at most this many tokens take the drop-free MoE dispatch
#: (``src/repro/models/transformer.py:336``)
RAGGED_MAX_TOKENS = 2048
#: capacity factor of the per-row sorted dispatch of longer serve calls
SERVE_CAPACITY_FACTOR = 2.0
FAMILIES = ("dense", "moe", "vlm", "audio")
MOE_DISPATCHES = ("sorted", "ragged", "dense")


class TransformerLM:
    """GQA transformer (the ``dense``, ``moe``, ``vlm`` and ``audio``
    families) on one device, or serving on a (kv, hd) mesh."""

    KV_INT8_SCALE = 24.0  # fixed-point scale (values are post-norm, O(1))

    def __init__(self, cfg: ModelConfig, *, device=None,
                 use_kernels: bool = True, kv_dtype: str = "native",
                 capacity_factor: float = 1.25, moe_dispatch: str = "sorted",
                 remat: bool = True, remat_policy: str | None = None,
                 kernel_mesh=None, shard=None):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not served by TransformerLM: "
                "RG-LRU is RecurrentGemmaLM, RWKV-6 is RWKV6LM "
                "(build_model picks them)")
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype must be 'native' or 'int8', got "
                             f"{kv_dtype!r}")
        if moe_dispatch not in MOE_DISPATCHES:
            raise ValueError(f"moe_dispatch must be one of {MOE_DISPATCHES}"
                             f", got {moe_dispatch!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: False routes every kernel call to its plain version even on the
        #: card (the explicit escape hatch, ``ServeConfig.use_ref_path``)
        self.use_kernels = use_kernels
        self.kv_dtype = kv_dtype
        #: training's MoE dispatch and capacity factor (JAX's defaults);
        #: the serve paths pick their own (``_ffn_serve``)
        self.capacity_factor = capacity_factor
        self.moe_dispatch = moe_dispatch
        #: activation checkpointing of each superblock under grad (JAX's
        #: ``jax.checkpoint`` of its scan body)
        self.remat = remat
        if remat_policy not in L.REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of "
                             f"{L.REMAT_POLICIES}, got {remat_policy!r}")
        #: ``"dots"``: the checkpoint keeps each superblock's matmul outputs
        #: and recomputes the rest (JAX's ``dots_with_no_batch_dims_
        #: saveable``, ``src/repro/models/transformer.py:242-247``)
        self.remat_policy = remat_policy
        self.kernel_mesh = kernel_mesh
        #: the activation hook ``shard(x, name)`` at JAX's sites and with
        #: JAX's names (``launch.sharding.make_shard_hook``)
        self.shard = shard or L.no_shard
        self.dtype = L.DTYPES[cfg.param_dtype]
        #: layers a superblock; only its last one routes (JAX ``_is_moe_sub``)
        self.moe_every = cfg.moe_every if cfg.family == "moe" else 1
        if cfg.num_layers % self.moe_every:
            raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                             f"of moe_every {self.moe_every}")
        #: a token's trailing shape: ``(K,)`` codebooks for multi-codebook
        #: audio (tokens ``[..., K]``), ``()`` otherwise
        self.token_shape = ((cfg.num_codebooks,) if cfg.family == "audio"
                            and cfg.num_codebooks > 1 else ())

    @property
    def kernel_mesh(self):
        """A ('kv', 'hd') ``DeviceMesh`` (``launch.mesh``): with more than
        one rank the serve paths keep the KV pools split over it and
        dispatch the kernels through ``ops.*_sharded``.  Setting a mesh
        this rank is not in raises ``ValueError``, in the constructor and
        on a twin (``copy.copy`` with the mesh set) alike."""
        return self._kernel_mesh

    @kernel_mesh.setter
    def kernel_mesh(self, mesh) -> None:
        if mesh is not None and mesh.get_coordinate() is None:
            raise ValueError("kernel_mesh: this rank is not in the mesh")
        self._kernel_mesh = mesh

    def is_moe(self, layer: int) -> bool:
        """Whether layer ``layer`` has an MoE FFN."""
        return (self.cfg.family == "moe"
                and layer % self.moe_every == self.moe_every - 1)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def init(self, seed: int) -> Params:
        """Random weights from a seeded ``torch.Generator`` on the device,
        with the JAX package's distributions (not its numbers)."""
        cfg, dt = self.cfg, self.dtype
        gen = L.generator(self.device, seed)
        blocks = []
        for li in range(cfg.num_layers):
            blocks.append({
                "ln1": L.rmsnorm_init(cfg.d_model, dt, self.device),
                "attn": L.attention_init(gen, cfg, dt),
                "ln2": L.rmsnorm_init(cfg.d_model, dt, self.device),
                "mlp": (M.moe_init(gen, cfg, dt) if self.is_moe(li) else
                        L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt)),
            })
        books = cfg.num_codebooks if self.token_shape else 0

        def table(init, d_in, d_out):
            # audio: one per codebook, stacked (MusicGen over EnCodec
            # streams): embed [K, V, D], head [K, D, V]
            if not books:
                return init(gen, d_in, d_out, dt)
            return torch.stack([init(gen, d_in, d_out, dt)
                                for _ in range(books)])
        p: Params = {
            "embed": table(L.embed_init, cfg.vocab_size, cfg.d_model),
            "blocks": blocks,
            "ln_f": L.rmsnorm_init(cfg.d_model, dt, self.device),
        }
        if books or not cfg.tie_embeddings:
            p["head"] = table(L.dense_init, cfg.d_model, cfg.vocab_size)
        return p

    # ------------------------------------------------------------------
    # embedding / logits
    # ------------------------------------------------------------------

    def embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        if self.token_shape:
            # tokens [..., K]: the sum of the per-codebook rows
            books = torch.arange(self.cfg.num_codebooks,
                                 device=tokens.device)
            per_book = params["embed"][books, tokens.long()]   # [..., K, D]
            return per_book.sum(dim=-2).to(self.dtype)
        return params["embed"][tokens.long()]

    def logits_fn(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.token_shape:
            return torch.einsum("...d,kdv->...kv", h, params["head"])
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return h @ params["head"]

    # ------------------------------------------------------------------
    # training forward
    # ------------------------------------------------------------------

    def _block_apply(self, p: Params, x: torch.Tensor,
                     positions: torch.Tensor, is_moe: bool):
        """One layer of the training forward (JAX ``_block_apply``,
        ``src/repro/models/transformer.py:171-206``).  Returns (x, the
        layer's router aux loss, 0 for a dense layer)."""
        cfg = self.cfg
        x = self.shard(x, "act_btd")
        x = x + L.attention_train(
            p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg,
            use_kernel=self.use_kernels)
        hn = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if not is_moe:
            return (self.shard(x + L.swiglu(p["mlp"], hn), "act_btd"),
                    x.new_zeros((), dtype=torch.float32))
        b, s, d = hn.shape
        moe_kw = dict(num_experts=cfg.num_experts, k=cfg.experts_per_token)
        if self.moe_dispatch == "sorted":
            # per-row groups, capacity per row: drops past it
            ff, aux = M.moe_apply_sorted_rows(
                p["mlp"], hn, capacity_factor=self.capacity_factor, **moe_kw)
            return self.shard(x + ff, "act_btd"), aux
        if self.moe_dispatch == "ragged":
            ff, aux = M.moe_apply_ragged(p["mlp"], hn.reshape(b * s, d),
                                         use_kernel=self.use_kernels,
                                         **moe_kw)
        else:
            ff, aux = M.moe_apply_dense(p["mlp"], hn.reshape(b * s, d),
                                        **moe_kw)
        return self.shard(x + ff.reshape(b, s, d), "act_btd"), aux

    def _superblock_apply(self, blocks: list, x: torch.Tensor,
                          positions: torch.Tensor, first: int):
        """The layers ``first, first + 1, ...`` of one superblock of
        ``moe_every`` (JAX ``_superblock_apply``, the body of its scan).
        Returns (x, the superblock's summed router aux loss)."""
        aux = None
        for i, p in enumerate(blocks):
            x, a = self._block_apply(p, x, positions, self.is_moe(first + i))
            aux = a if aux is None else aux + a
        return x, aux

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                vision_embeds: torch.Tensor | None = None):
        """The training forward of ``tokens [B, S]`` (``[B, S, K]``
        audio) at ``positions [B, S]`` (``[3, B, S]`` M-RoPE; default
        ``arange(S)``); ``vision_embeds [B, Nvis, D]`` replace the first
        embedded positions.  Returns (final-norm hidden [B, S, D], the
        router aux loss: over each superblock of ``moe_every`` layers the
        sum, over superblocks the mean; 0 outside the moe family).  Under
        grad mode with ``remat`` each superblock is checkpointed."""
        cfg = self.cfg
        b, s = tokens.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
            if cfg.mrope_sections:
                positions = positions.expand(3, b, s)
        x = self.embed(params, tokens)
        if vision_embeds is not None:
            nvis = vision_embeds.shape[1]
            x = torch.cat([vision_embeds.to(x.dtype), x[:, nvis:]], dim=1)
        auxs, m = [], self.moe_every
        for first in range(0, len(params["blocks"]), m):
            x, a = L.remat_apply(self.remat, self._superblock_apply,
                                 params["blocks"][first:first + m], x,
                                 positions, first, policy=self.remat_policy)
            auxs.append(a)
        aux = (torch.stack(auxs).mean() if cfg.family == "moe"
               else x.new_zeros((), dtype=torch.float32))
        return L.rmsnorm(params["ln_f"], x, cfg.norm_eps), aux

    def loss(self, params: Params, batch: dict[str, torch.Tensor]):
        """``batch``: tokens, labels, and optionally mask, positions,
        vision_embeds.  Returns (xent + 0.01 aux, {"xent", "aux"});
        audio averages the cross entropy over its codebook heads."""
        h, aux = self.forward(params, batch["tokens"], batch.get("positions"),
                              batch.get("vision_embeds"))
        logits = self.shard(self.logits_fn(params, h), "logits")
        mask = batch.get("mask")
        if self.token_shape:        # logits [B, S, K, V], labels [B, S, K]
            xent = torch.stack([
                L.softmax_xent(logits[..., i, :], batch["labels"][..., i],
                               mask)
                for i in range(self.cfg.num_codebooks)]).mean()
        else:
            xent = L.softmax_xent(logits, batch["labels"], mask)
        return xent + 0.01 * aux, {"xent": xent, "aux": aux}

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

    # ------------------------------------------------------------------
    # the serve mesh
    # ------------------------------------------------------------------

    def _serve_kernel_mesh(self):
        """The ('kv', 'hd') mesh the serve paths shard over, or None for
        one device (JAX ``_serve_kernel_mesh``).  JAX drops the mesh when
        ``use_kernels`` is off and lets GSPMD split its plain ops; the port
        keeps it, and the plain versions run on each rank's slice through
        the same wrappers."""
        m = self.kernel_mesh
        return m if m is not None and m.size() > 1 else None

    def _split(self, t: torch.Tensor, mesh, kv_dim: int,
               hd_dim: int | None = None):
        """``t`` (the same on every rank) as a DTensor split over 'kv' on
        ``kv_dim`` and over 'hd' on ``hd_dim``, where ``kv_partition_axes``
        lets them split; ``t`` itself where there is no mesh."""
        if mesh is None:
            return t
        return ops.shard_tensor(t, mesh, ops.kv_layout(
            mesh, self.cfg.num_kv_heads, self.cfg.head_dim, kv_dim, hd_dim))

    @staticmethod
    def _layer_pools(state: PagedKVState, li: int, mesh):
        """Layer ``li``'s K and V pools, views of the stacked pools (on a
        mesh: this rank's slice, wrapped with the layer's placements)."""
        return _layer(state.k_pools, li, mesh), _layer(state.v_pools, li,
                                                        mesh)

    def init_kv_state(self, batch: int, num_pages: int, page_size: int,
                      max_pages: int) -> PagedKVState:
        """Zeroed pools ``[L, P, page, Hkv, hd]`` (on a mesh of more than
        one rank, DTensors split over (kv, hd) as ``kv_partition_axes``
        says, each rank holding its slice), an unmapped page table and
        zero lengths (replicated plain tensors)."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        mesh = self._serve_kernel_mesh()

        def pool():
            if mesh is None:
                return torch.zeros(shape, dtype=self._kv_store_dtype(),
                                   device=dev)
            # only the local slice of the broadcast zero is materialised
            zero = torch.zeros((), dtype=self._kv_store_dtype(), device=dev)
            return self._split(zero.expand(shape), mesh, 3, 4)
        return PagedKVState(
            k_pools=pool(),
            v_pools=pool(),
            page_table=torch.full((batch, max_pages), INVALID_PAGE,
                                  dtype=torch.int32, device=dev),
            seq_lens=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )

    def _rope(self, positions: torch.Tensor):
        """RoPE tables for ``positions [B, S]``, computed once per serve
        call; M-RoPE tables where the config has sections, with the
        positions as all three streams (the serve paths carry text
        positions, as in JAX)."""
        cfg = self.cfg
        if cfg.mrope_sections:
            pos3 = positions.expand(3, *positions.shape)
            return L.mrope_tables(pos3, cfg.head_dim, cfg.rope_theta,
                                  cfg.mrope_sections)
        return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def _block_serve_qkv(self, p, x, rope):
        """Shared q/k/v + rope for serve paths. x [B, T, D]."""
        cfg = self.cfg
        q, k, v = L.qkv_project(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                cfg)
        return L.rotate(q, *rope), L.rotate(k, *rope), v

    def _ffn_serve(self, p, x, is_moe: bool):
        cfg = self.cfg
        hn = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if not is_moe:
            return x + L.swiglu(p["mlp"], hn)
        shp = hn.shape
        if shp[0] * shp[1] <= RAGGED_MAX_TOKENS:
            # decode and short prefill: drop-free grouped products
            ff, _ = M.moe_apply_ragged(
                p["mlp"], hn.reshape(-1, shp[-1]),
                num_experts=cfg.num_experts, k=cfg.experts_per_token,
                use_kernel=self.use_kernels)
        else:
            # long prefill: per-row sorted dispatch with generous capacity
            ff, _ = M.moe_apply_sorted_rows(
                p["mlp"], hn, num_experts=cfg.num_experts,
                k=cfg.experts_per_token,
                capacity_factor=SERVE_CAPACITY_FACTOR)
        return x + ff.reshape(shp)

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                prompt_lens: torch.Tensor, state: PagedKVState,
                vision_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, PagedKVState]:
        """Run padded prompts ``tokens [B, S]`` (``[B, S, K]`` audio; true
        lengths ``prompt_lens [B]`` int32), write KV through the page table
        (burst copies, in place).  ``vision_embeds [B, Nvis, D]``
        (precomputed patch embeddings, the stub vision front end) replace
        the first ``Nvis`` embedded positions.  Returns (last-token logits
        [B, V] or [B, K, V], state with seq_lens = prompt_lens)."""
        cfg = self.cfg
        b, s = tokens.shape[:2]
        page = state.page_size
        rope = self._rope(torch.arange(s, device=tokens.device).expand(b, s))
        x = self.embed(params, tokens)
        if vision_embeds is not None:
            nvis = vision_embeds.shape[1]
            x = torch.cat([vision_embeds.to(x.dtype), x[:, nvis:]], dim=1)
        mesh = self._serve_kernel_mesh()
        for li, block_p in enumerate(params["blocks"]):
            q, k, v = self._block_serve_qkv(block_p, x, rope)
            # unit-stride burst write of K and V through the page table
            # (C2-burst), one launch; the pool stores its own dtype
            # (quantized under int8), the chunk's own attention below keeps
            # the raw activations
            ops.paged_copy_kv_sharded(
                self._split(self._kv_quant(k), mesh, 2, 3),
                self._split(self._kv_quant(v), mesh, 2, 3),
                *self._layer_pools(state, li, mesh), state.page_table,
                prompt_lens, page_size=page, mesh=mesh,
                use_kernel=self.use_kernels,
            )
            # on a mesh the heads are split over 'kv', and gathered whole
            # before the replicated wo (GSPMD's implicit all-gather in JAX)
            o = ops.unshard(ops.flash_attention_sharded(
                *(self._split(t.transpose(1, 2), mesh, 1) for t in (q, k, v)),
                causal=True, mesh=mesh, use_kernel=self.use_kernels,
            ))                                        # [B, Hq, S, hd]
            x = x + o.transpose(1, 2).reshape(b, s, -1) @ block_p["attn"]["wo"]
            x = self._ffn_serve(block_p, x, self.is_moe(li))
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        last_idx = (prompt_lens.long() - 1).clamp(min=0)
        last = x[torch.arange(b, device=x.device), last_idx]
        logits = self.logits_fn(params, last)
        return logits, state._replace(seq_lens=prompt_lens.to(torch.int32))

    @torch.no_grad()
    def prefill_continue(self, params: Params, tokens: torch.Tensor,
                         start_lens: torch.Tensor, chunk_lens: torch.Tensor,
                         state: PagedKVState
                         ) -> tuple[torch.Tensor, PagedKVState]:
        """Chunked prefill at arbitrary start offsets (continuation).

        Extends sequences that already hold ``start_lens [B]`` tokens in
        the paged cache by padded chunks ``tokens [B, S]`` (true lengths
        ``chunk_lens [B]``): per layer, K and V are written in one launch
        at logical positions ``start + t`` through the page table
        (``paged_copy_kv_at``, quantized under int8), then each chunk
        query attends causally over
        cache plus chunk through the table (``paged_prefill_attention``).
        The host must have mapped pages covering ``[start, start + chunk)``.
        Returns (logits of each row's last chunk token [B, V], state with
        seq_lens = start_lens + chunk_lens)."""
        cfg = self.cfg
        b, s = tokens.shape[:2]
        page = state.page_size
        hkv, hd, g = cfg.num_kv_heads, cfg.head_dim, cfg.q_per_kv
        positions = (start_lens[:, None]
                     + torch.arange(s, device=tokens.device)[None, :])
        rope = self._rope(positions)
        kv_scale = self._kv_scale()
        x = self.embed(params, tokens)
        mesh = self._serve_kernel_mesh()
        for li, block_p in enumerate(params["blocks"]):
            q, k, v = self._block_serve_qkv(block_p, x, rope)
            kp, vp = self._layer_pools(state, li, mesh)
            ops.paged_copy_kv_at_sharded(
                self._split(self._kv_quant(k), mesh, 2, 3),
                self._split(self._kv_quant(v), mesh, 2, 3),
                kp, vp, state.page_table, start_lens, chunk_lens,
                page_size=page, mesh=mesh, use_kernel=self.use_kernels,
            )
            o = ops.unshard(ops.paged_prefill_attention_sharded(
                self._split(q.reshape(b, s, hkv, g, hd), mesh, 2), kp, vp,
                state.page_table, start_lens, page_size=page, mesh=mesh,
                kv_scale=kv_scale, use_kernel=self.use_kernels,
            ))                                        # [B, S, Hkv, G, hd]
            x = x + o.reshape(b, s, hkv * g * hd) @ block_p["attn"]["wo"]
            x = self._ffn_serve(block_p, x, self.is_moe(li))
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        last_idx = (chunk_lens.long() - 1).clamp(min=0)
        last = x[torch.arange(b, device=x.device), last_idx]
        logits = self.logits_fn(params, last)
        return logits, state._replace(
            seq_lens=(start_lens + chunk_lens).to(torch.int32))

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
        mesh = self._serve_kernel_mesh()
        for li, block_p in enumerate(params["blocks"]):
            q, k, v = self._block_serve_qkv(block_p, x, rope)
            kp, vp = self._layer_pools(state, li, mesh)
            # the single-token row scatter is a plain index_put_; on a mesh
            # each rank writes its (kv, hd) slice of the new K/V into its
            # pool slice (GSPMD splits JAX's .at[rows].set the same way)
            for pool, new in ((kp, k[:, 0]), (vp, v[:, 0])):
                new = self._kv_quant(new)
                if mesh is not None:
                    pool = pool.to_local()
                    new = self._split(new, mesh, 1, 2).to_local()
                pool.view(-1, *new.shape[1:])[rows] = new
            o = ops.unshard(ops.paged_decode_attention_sharded(
                self._split(q[:, 0].reshape(b, hkv, g, hd), mesh, 1), kp, vp,
                state.page_table, new_lens, page_size=page, mesh=mesh,
                kv_scale=kv_scale, use_kernel=self.use_kernels,
            ))                                         # [B, Hkv, G, hd]
            x = x + o.reshape(b, 1, hkv * g * hd) @ block_p["attn"]["wo"]
            x = self._ffn_serve(block_p, x, self.is_moe(li))
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
        freezes their ``seq_lens``.  Returns ``(token_block [horizon, B]``
        (``[horizon, B, K]`` audio)``, state)``; block rows at ``t >=
        steps_left[i]`` are scratch."""
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
            # the lane mask along the lane axis, whatever a token's shape
            lane = active.reshape((-1,) + (1,) * (toks.dim() - 1))
            toks = torch.where(lane, new_tok, toks)
            seq_lens = ns.seq_lens
            block.append(new_tok)
        return torch.stack(block), state._replace(seq_lens=seq_lens)


def _layer(pools, li: int, mesh):
    """``pools[li]``: a view; on a mesh (a DTensor split on its later
    dims), the local slice's layer wrapped again with the placements moved
    down one dim (no dispatch through DTensor's ops, no communication)."""
    from torch.distributed.tensor import Shard
    if mesh is None:
        return pools[li]
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in pools.placements)
    return ops.wrap_local(pools.to_local()[li], pools.device_mesh, pl,
                          pools.shape[1:])


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

    The JAX pytree stacks each block leaf of a superblock of ``m =
    moe_every`` layers along a leading axis under
    ``params["blocks"]["sub0"]`` ... ``["sub{m-1}"]``; the port keeps one
    dict per layer, layer ``i`` from ``sub{i % m}[i // m]``.  Weights keep
    their ``[in, out]`` layout (experts ``[E, in, out]``; audio's stacked
    per-codebook ``embed [K, V, D]`` and ``head [K, D, V]`` carry across as
    they are).  The dense, MoE, VLM and audio families
    (:func:`repro_torch.models.params_from_jax` dispatches by family)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: not a "
                                  "TransformerLM family's pytree")
    m = cfg.moe_every if cfg.family == "moe" else 1
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else t(v[i])
                for k, v in tree.items()}

    subs = np_params["blocks"]
    out: Params = {
        "embed": t(np_params["embed"]),
        "blocks": [layer(subs[f"sub{i % m}"], i // m)
                   for i in range(cfg.num_layers)],
        "ln_f": {"scale": t(np_params["ln_f"]["scale"])},
    }
    if "head" in np_params:
        out["head"] = t(np_params["head"])
    return out
