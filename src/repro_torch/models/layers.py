"""Dense-transformer layers in PyTorch: norms, RoPE and M-RoPE, GQA
projections and training attention, MLP, the tanh GELU, the LM loss.

Conventions (those of ``src/repro/models/layers.py``):
  * params are plain dicts of tensors; weights keep the JAX ``[in, out]``
    layout and are applied as ``x @ W``;
  * compute dtype follows the input; normalization statistics accumulate
    in f32; RoPE tables are built in f32;
  * initializers draw the same distributions as the JAX package from an
    explicit ``torch.Generator`` on the target device (the numbers differ
    from ``jax.random``; the tests bridge JAX weights instead).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops, ref

Params = dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def no_shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """The models' default activation hook: ``x`` as it is."""
    return x


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device, so the
    initializers, which draw on ``gen.device``, make meta tensors."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The seeded ``torch.Generator`` a model's ``init`` draws from, on
    ``device``; on ``meta`` one that makes tensors of shapes only (JAX's
    ``jax.eval_shape(model.init)``)."""
    if device.type == "meta":
        return _MetaGenerator().manual_seed(int(seed))
    return torch.Generator(device=device).manual_seed(int(seed))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def attention_init(gen: torch.Generator, cfg, dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    return p


def swiglu_init(gen: torch.Generator, d: int, f: int, dtype) -> Params:
    return {
        "w_gate": dense_init(gen, d, f, dtype),
        "w_up": dense_init(gen, d, f, dtype),
        "w_down": dense_init(gen, f, d, dtype),
    }


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2], f32.  Made on the device (no
    host-to-device copy), so a CUDA graph can capture it."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) ``[..., S, 1, D/2]`` in f32 for ``positions [..., S]``:
    built once per forward call and shared by every layer."""
    inv = rope_freqs(head_dim, theta, positions.device)     # [D/2]
    ang = positions[..., None].float() * inv                # [..., S, D/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def mrope_tables(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]):
    """M-RoPE (qwen2-vl) tables ``[B, S, 1, D/2]`` in f32 for
    ``positions3 [3, B, S]`` (temporal, height, width streams): the D/2
    frequency slots are split into t/h/w sections, each slot taking the
    angle of the stream its section names
    (``src/repro/models/layers.py:86-110``).  The sections are contiguous,
    so the selection is three slices (no index tensor to upload, so a
    CUDA graph can capture it).  Text tokens carry t == h == w, which
    reduces to :func:`rope_tables`."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover "
                         f"head_dim // 2 = {head_dim // 2}")
    inv = rope_freqs(head_dim, theta, positions3.device)    # [D/2]
    ang_thw = positions3[..., None].float() * inv           # [3, B, S, D/2]
    parts, off = [], 0
    for stream, n in enumerate(sections):
        parts.append(ang_thw[stream, ..., off:off + n])
        off += n
    ang = torch.cat(parts, dim=-1)                          # [B, S, D/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Split-half rotation (``src/repro/models/layers.py:72-83``) of
    ``x [..., S, H, D]`` by precomputed tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor,            # [..., S, H, D]
               positions: torch.Tensor,    # [..., S]
               theta: float) -> torch.Tensor:
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor,             # [B, S, H, D]
                positions3: torch.Tensor,    # [3, B, S]
                theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    return rotate(x, *mrope_tables(positions3, x.shape[-1], theta, sections))


def qkv_project(params: Params, x: torch.Tensor, cfg):
    """x [B, S, D] -> q [B, S, H, hd], k/v [B, S, Hkv, hd]."""
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def attention_train(params: Params, x: torch.Tensor,
                    positions: torch.Tensor, cfg, *,
                    use_kernel: bool = False,
                    window: int | None = None) -> torch.Tensor:
    """Full (or sliding-window) causal self-attention of ``x [B, S, D]``
    for training, ``positions [B, S]`` (``[3, B, S]`` under M-RoPE); JAX
    ``layers.attention_train`` (``src/repro/models/layers.py:147-177``),
    branch for branch:

      * ``use_kernel`` and no window: ``ops.flash_attention`` (the
        hand-written kernel on the card, which refuses inputs that require
        grad under grad mode);
      * more than 1,024 tokens or a window:
        ``ref.chunked_attention_flashbwd_ref``, whose backward keeps O(S)
        residuals;
      * otherwise ``ref.flash_attention_ref``, under autograd."""
    q, k, v = qkv_project(params, x, cfg)
    if cfg.mrope_sections:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, hd]
    b, s = x.shape[:2]
    if use_kernel and window is None:
        o = ops.flash_attention(qt, kt, vt, causal=True)
    elif s > 1024 or window is not None:
        o = ref.chunked_attention_flashbwd_ref(qt, kt, vt, causal=True,
                                               window=window)
    else:
        o = ref.flash_attention_ref(qt, kt, vt, causal=True)
    return o.transpose(1, 2).reshape(b, s, -1) @ params["wo"]


def _windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int) -> torch.Tensor:
    """Causal attention of ``q [B, Hq, S, D]`` over the last ``window``
    keys, with the whole ``[S, S]`` score matrix (JAX
    ``layers._windowed_attention``, ``:180-195``; no caller in either
    package)."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    qg = q.reshape(b, k.shape[1], g, s, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                          k.float()) * (d ** -0.5)
    pos = torch.arange(s, device=q.device)
    diff = pos[:, None] - pos[None, :]
    scores = torch.where((diff >= 0) & (diff < window), scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, s, d).to(q.dtype)


# ---------------------------------------------------------------------------
# batch statistics over data-parallel ranks
# ---------------------------------------------------------------------------

#: the process groups a batch is split over (:func:`data_parallel`); empty
#: where this process holds the whole batch
_DP_GROUPS: tuple = ()


@contextlib.contextmanager
def data_parallel(groups):
    """Inside, the losses' batch statistics (the cross entropy's masked
    sum and token count, the MoE router's batch means) are summed over the
    ranks of ``groups``, each rank holding an equal share of the batch's
    rows: every rank computes the loss of the whole batch, and the
    gradients of its rows' share of it (their sum over ``groups`` is the
    batch's gradient).  ``groups``: one process group per data-parallel
    mesh axis."""
    global _DP_GROUPS
    saved, _DP_GROUPS = _DP_GROUPS, tuple(groups)
    try:
        yield
    finally:
        _DP_GROUPS = saved


class _BatchSum(torch.autograd.Function):
    """The sum over :data:`_DP_GROUPS`; its backward passes the gradient
    through, so each rank back-propagates into its own rows only."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist
        out = x.clone()
        for g in _DP_GROUPS:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel ranks (:func:`data_parallel`);
    ``x`` itself outside."""
    return _BatchSum.apply(x) if _DP_GROUPS else x


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data-parallel ranks of a mean over each rank's
    equal share of the batch: the batch's mean; ``x`` itself outside
    :func:`data_parallel`."""
    if not _DP_GROUPS:
        return x
    import torch.distributed as dist
    return batch_sum(x) / math.prod(dist.get_world_size(g)
                                    for g in _DP_GROUPS)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean causal-LM cross entropy of ``logits [B, S, V]`` against
    ``labels [B, S]``, f32 statistics; a ``mask`` weights the tokens and
    divides by ``max(mask.sum(), 1)`` (JAX ``layers.softmax_xent``).
    Under :func:`data_parallel` the mean is the whole batch's."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return batch_mean(nll.mean())
    mask = mask.float()
    num, den = (nll * mask).sum(), mask.sum()
    if _DP_GROUPS:
        num, den = batch_sum(torch.stack([num, den])).unbind()
    return num / den.clamp(min=1.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default ``approximate=True``: the tanh
    form, ``0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))``."""
    return F.gelu(x, approximate="tanh")


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------


#: the ops whose outputs the ``"dots"`` policy saves: matmuls with no batch
#: dims (``x @ W`` folds its leading dims into one ``mm``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
#: ``remat_policy`` values: None (save the inputs only) and ``"dots"``
REMAT_POLICIES = (None, "dots")


def _dots_saveable(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep each ``mm`` /
    ``addmm`` output, recompute everything else (the attention ``bmm``s
    too)."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_apply(remat: bool, fn, *args, policy: str | None = None):
    """``fn(*args)``; under grad mode with ``remat``, through
    ``torch.utils.checkpoint`` (non-reentrant): the body keeps only its
    inputs and recomputes its activations in the backward (JAX's
    ``jax.checkpoint`` of a scan body).  ``policy="dots"`` is a selective
    checkpoint that also keeps its matmuls' outputs (JAX's
    ``jax.checkpoint(..., policy=dots_with_no_batch_dims_saveable)``).
    Under ``torch.no_grad()`` the body runs as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    if remat and torch.is_grad_enabled():
        kwargs = {}
        if policy == "dots":
            kwargs["context_fn"] = functools.partial(
                torch.utils.checkpoint.create_selective_checkpoint_contexts,
                _dots_saveable)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False,
                                                 **kwargs)
    return fn(*args)
