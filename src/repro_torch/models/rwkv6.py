"""RWKV-6 "Finch" — attention-free LM with data-dependent decay, in PyTorch.

Port of ``src/repro/models/rwkv6.py`` (``init``, ``forward``, ``loss``,
``init_state``, ``prefill``, ``decode_step``):
  * alternating time-mix and channel-mix blocks; time-mix computes r/k/v/g
    from token-shift interpolations and a data-dependent per-channel decay
    ``w_t = exp(-exp(w0 + LoRA(x_t)))``, then runs the linear-state
    recurrence (``ops.wkv6``: the sequential kernel, or the chunked one
    under ``tm_impl="chunked_matmul"`` when T is a multiple of 32);
    channel-mix is the squared-ReLU MLP;
  * the JAX package's simplifications are kept: RMSNorm, static
    token-shift mixing coefficients, per-head RMS normalization of the wkv
    output;
  * params are plain dicts of tensors with one dict per layer
    (``params["blocks"][i]``; the JAX pytree stacks each leaf along a
    leading layer axis — :func:`repro_torch.models.params_from_jax`
    unstacks), weights in the JAX ``[in, out]`` layout applied as
    ``x @ W``; ``w0``, ``w_lora_*`` and ``u`` are f32 in a bf16 model;
  * serving has no KV cache: the per-request state is O(1) in context
    length (:class:`RecurrentState`).  The serve calls return a new state;
    the state they were given is not changed;
  * training (``forward``, ``loss``) runs under autograd through the plain
    recurrence (``use_kernels=False``: ``wkv6_ref``, every step's state
    kept for the backward; JAX's ``wkv6_chunked_ref`` checkpoints one a
    chunk of 128 and recomputes the rest, the same sums).  A hand-written
    kernel has no backward: with ``use_kernels=True`` a grad-enabled loss
    raises in ``ops``.

Every tensor lives on ``self.device``: ``cuda`` unless the caller passes
``device="cpu"`` (the kernels' plain versions then run).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]
LORA_RANK = 64
TM_IMPLS = ("sequential", "chunked_matmul")


class RecurrentState(NamedTuple):
    """Per-request recurrent state, stacked over layers."""

    tm_shift: torch.Tensor   # [L, B, D]   last token seen by time-mix
    cm_shift: torch.Tensor   # [L, B, D]   last token seen by channel-mix
    wkv: torch.Tensor        # [L, B, H, N, N]  f32 recurrence state
    seq_lens: torch.Tensor   # [B] int32

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def _head_rms(x: torch.Tensor, scale: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS normalization of the wkv output. x [..., H, N]."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


class RWKV6LM:
    """The ``rwkv6`` family on one device."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 use_kernels: bool = True, tm_impl: str = "sequential",
                 remat: bool = True, shard=None):
        if cfg.family != "rwkv6":
            raise ValueError(f"RWKV6LM serves the rwkv6 family, got "
                             f"{cfg.family!r}")
        if tm_impl not in TM_IMPLS:
            raise ValueError(f"tm_impl must be one of {TM_IMPLS}, got "
                             f"{tm_impl!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        #: False routes the recurrence to its plain versions even on the
        #: card (JAX's ``use_kernels=False`` routes)
        self.use_kernels = use_kernels
        self.tm_impl = tm_impl
        #: activation checkpointing of each layer under grad (JAX's
        #: ``jax.checkpoint`` of its scan body)
        self.remat = remat
        #: the activation hook ``shard(x, name)`` at JAX's sites
        self.shard = shard or L.no_shard
        self.dtype = L.DTYPES[cfg.param_dtype]

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def _init_block(self, gen: torch.Generator) -> Params:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        d, f = cfg.d_model, cfg.d_ff
        h, n = cfg.num_rwkv_heads, cfg.rwkv_head_size

        def u01(*shape):
            return torch.rand(shape, generator=gen, dtype=torch.float32,
                              device=dev)

        return {
            "ln1": L.rmsnorm_init(d, dt, dev),
            "ln2": L.rmsnorm_init(d, dt, dev),
            "tm": {
                "mu_r": u01(d).to(dt),
                "mu_k": u01(d).to(dt),
                "mu_v": u01(d).to(dt),
                "mu_g": u01(d).to(dt),
                "mu_w": u01(d).to(dt),
                "w0": -6.0 + u01(d) * 2.0,                           # f32
                "w_lora_A": L.dense_init(gen, d, LORA_RANK, torch.float32),
                "w_lora_B": torch.zeros((LORA_RANK, d), dtype=torch.float32,
                                        device=dev),
                "wr": L.dense_init(gen, d, d, dt),
                "wk": L.dense_init(gen, d, d, dt),
                "wv": L.dense_init(gen, d, d, dt),
                "wg": L.dense_init(gen, d, d, dt),
                "wo": L.dense_init(gen, d, d, dt),
                "u": u01(h, n) - 0.5,                                # f32
                "ln_x": torch.ones((d,), dtype=dt, device=dev),
            },
            "cm": {
                "mu": u01(d).to(dt),
                "wr": L.dense_init(gen, d, d, dt),
                "wk": L.dense_init(gen, d, f, dt),
                "wv": L.dense_init(gen, f, d, dt),
            },
        }

    def init(self, seed: int) -> Params:
        """Random weights from a seeded ``torch.Generator`` on the device,
        with the JAX package's distributions (not its numbers):
        ``w_lora_B`` starts at zero, as there."""
        cfg, dt = self.cfg, self.dtype
        gen = L.generator(self.device, seed)
        return {
            "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "blocks": [self._init_block(gen) for _ in range(cfg.num_layers)],
            "ln_f": L.rmsnorm_init(cfg.d_model, dt, self.device),
            "head": L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
        }

    # ------------------------------------------------------------------
    # block math
    # ------------------------------------------------------------------

    def _decay(self, tm: Params, xw: torch.Tensor) -> torch.Tensor:
        """Data-dependent decay in (0, 1): exp(-exp(w0 + LoRA(xw))), f32."""
        lora = torch.tanh(xw.float() @ tm["w_lora_A"]) @ tm["w_lora_B"]
        return torch.exp(-torch.exp(tm["w0"] + lora))

    def _time_mix(self, p: Params, x: torch.Tensor, x_prev: torch.Tensor,
                  wkv_state: torch.Tensor, wkv_out: torch.Tensor):
        """x [B, T, D]; x_prev [B, D]; wkv_state [B, H, N, N] f32, read;
        ``wkv_out`` (same shape, or None) receives the new state in place.
        Returns (out [B, T, D], new x_prev, the new state [B*H, N, N])."""
        cfg = self.cfg
        b, t, d = x.shape
        h, n = cfg.num_rwkv_heads, cfg.rwkv_head_size
        tm = p["tm"]
        shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)

        def mix(mu):
            return x + (shifted - x) * mu

        r = mix(tm["mu_r"]) @ tm["wr"]
        k = mix(tm["mu_k"]) @ tm["wk"]
        v = mix(tm["mu_v"]) @ tm["wv"]
        g = mix(tm["mu_g"]) @ tm["wg"]
        w = self._decay(tm, mix(tm["mu_w"]))                   # [B, T, D] f32

        def to_heads(z):                                       # [B*H, T, N]
            return z.reshape(b, t, h, n).transpose(1, 2).reshape(
                b * h, t, n).float().contiguous()

        u = tm["u"].repeat(b, 1)                               # [B*H, N]
        o, s = ops.wkv6(
            to_heads(r), to_heads(k), to_heads(v), to_heads(w), u,
            wkv_state.reshape(b * h, n, n),
            use_kernel=self.use_kernels,
            matmul_chunks=(self.tm_impl == "chunked_matmul"),
            out_state=None if wkv_out is None else wkv_out.view(b * h, n, n),
        )
        o = o.reshape(b, h, t, n).transpose(1, 2)              # [B, T, H, N]
        o = _head_rms(o, tm["ln_x"].reshape(h, n)).reshape(b, t, d)
        out = (o.to(x.dtype) * F.silu(g)) @ tm["wo"]
        return out, x[:, -1, :], s

    def _channel_mix(self, p: Params, x: torch.Tensor, x_prev: torch.Tensor):
        cm = p["cm"]
        shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
        xm = x + (shifted - x) * cm["mu"]
        rr = torch.sigmoid(xm @ cm["wr"])
        kk = torch.square(torch.relu(xm @ cm["wk"]))
        return rr * (kk @ cm["wv"]), x[:, -1, :]

    def _block(self, block_p: Params, x, tm_prev, cm_prev, wkv, wkv_out):
        cfg = self.cfg
        x = self.shard(x, "act_btd")
        xn = L.rmsnorm(block_p["ln1"], x, cfg.norm_eps)
        tm_out, tm_new, s = self._time_mix(block_p, xn, tm_prev, wkv,
                                           wkv_out)
        x = x + tm_out
        xn = L.rmsnorm(block_p["ln2"], x, cfg.norm_eps)
        cm_out, cm_new = self._channel_mix(block_p, xn, cm_prev)
        return x + cm_out, tm_new, cm_new, s

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def forward(self, params: Params, tokens: torch.Tensor,
                state: RecurrentState | None = None
                ) -> tuple[torch.Tensor, RecurrentState]:
        """tokens [B, T] -> (final-norm hidden states [B, T, D], the state
        after the T tokens, with seq_lens advanced by T).  Runs under
        autograd when grad mode is on (training), each layer checkpointed
        under ``remat`` (the new wkv states then stacked, not written in
        place); ``prefill`` and ``decode_step`` call it under
        ``torch.no_grad()``."""
        cfg = self.cfg
        b, t = tokens.shape
        x = params["embed"][tokens.long()]
        if state is None:
            state = self.init_state(b)
        remat = self.remat and torch.is_grad_enabled()
        wkv_new = None if remat else torch.empty_like(state.wkv)
        tm_s, cm_s, wkv_s = [], [], []
        for li, block_p in enumerate(params["blocks"]):
            args = (block_p, x, state.tm_shift[li], state.cm_shift[li],
                    state.wkv[li])
            if remat:
                x, tm_new, cm_new, s = L.remat_apply(True, self._block,
                                                     *args, None)
                wkv_s.append(s.view(state.wkv[li].shape))
            else:
                x, tm_new, cm_new, _ = self._block(*args, wkv_new[li])
            tm_s.append(tm_new)
            cm_s.append(cm_new)
        new_state = RecurrentState(
            torch.stack(tm_s), torch.stack(cm_s),
            torch.stack(wkv_s) if remat else wkv_new, state.seq_lens + t)
        return L.rmsnorm(params["ln_f"], x, cfg.norm_eps), new_state

    def loss(self, params: Params, batch: dict[str, torch.Tensor]):
        """Mean cross entropy of ``batch["tokens"] [B, T]`` against
        ``batch["labels"]`` (``batch["mask"]`` optional) from a zero state;
        returns (xent, {"xent", "aux": 0})."""
        h, _ = self.forward(params, batch["tokens"])
        xent = L.softmax_xent(self.shard(h @ params["head"], "logits"),
                              batch["labels"], batch.get("mask"))
        return xent, {"xent": xent, "aux": xent.new_zeros(())}

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def init_state(self, batch: int) -> RecurrentState:
        cfg, dev = self.cfg, self.device
        h, n = cfg.num_rwkv_heads, cfg.rwkv_head_size
        zeros_d = torch.zeros((cfg.num_layers, batch, cfg.d_model),
                              dtype=self.dtype, device=dev)
        return RecurrentState(
            zeros_d, zeros_d.clone(),
            torch.zeros((cfg.num_layers, batch, h, n, n), dtype=torch.float32,
                        device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev),
        )

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                prompt_lens: torch.Tensor, state: RecurrentState
                ) -> tuple[torch.Tensor, RecurrentState]:
        """As the JAX prefill: the recurrence consumes all T columns of the
        padded batch (exact only for equal lengths), ``prompt_lens`` picks
        each row's last-token logits and advances ``seq_lens``.  Returns
        (last-token logits [B, V], state)."""
        b = tokens.shape[0]
        h, new_state = self.forward(params, tokens, state)
        last_idx = (prompt_lens.long() - 1).clamp(min=0)
        last = h[torch.arange(b, device=h.device), last_idx]
        new_state = new_state._replace(
            seq_lens=state.seq_lens + prompt_lens.to(torch.int32))
        return last @ params["head"], new_state

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: torch.Tensor,
                    state: RecurrentState
                    ) -> tuple[torch.Tensor, RecurrentState]:
        """One token per row: tokens [B] -> (logits [B, V], state)."""
        h, new_state = self.forward(params, tokens[:, None], state)
        return h[:, 0] @ params["head"], new_state


def params_from_jax(np_params: Params, cfg: ModelConfig, device) -> Params:
    """Bridge: the JAX ``RWKV6LM.init`` pytree (as numpy arrays) to the
    port's parameters on ``device``.  The JAX tree stacks each leaf of
    ``params["blocks"]`` along a leading layer axis (no ``sub0`` level);
    the port keeps one dict per layer.  Layouts and dtypes are kept."""
    if cfg.family != "rwkv6":
        raise ValueError(f"not an rwkv6 config: {cfg.family!r}")
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else t(v[i])
                for k, v in tree.items()}

    return {
        "embed": t(np_params["embed"]),
        "blocks": [layer(np_params["blocks"], i)
                   for i in range(cfg.num_layers)],
        "ln_f": {"scale": t(np_params["ln_f"]["scale"])},
        "head": t(np_params["head"]),
    }
