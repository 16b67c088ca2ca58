"""Mixture-of-Experts FFN with sort-based dispatch, in PyTorch.

Port of ``src/repro/models/moe.py``, function for function, with the same
semantics:

  * ``moe_apply_sorted`` — GShard capacity dispatch: assignments are
    stably sorted by expert, packed into per-expert capacity buffers by
    rank, run through the batched products ``[E, C, D] x [E, D, F]`` and
    combined by gather and gate-weighted sum; assignments past an expert's
    capacity are dropped.  ``moe_apply_sorted_rows`` runs it per batch row
    (the serve path's prefill above 2,048 tokens, capacity factor 2.0);
  * ``moe_apply_ragged`` — drop-free dispatch: the three FFN products are
    grouped products over the sorted assignments with exact per-expert
    group sizes (``ops.ragged_dot``, a hand-written kernel on the card);
    the serve path's dispatch at 2,048 tokens and fewer;
  * ``moe_apply_dense`` — the O(E T) oracle.

Every op on these paths is safe to capture in a CUDA graph: no host read of
a device value (group sizes come from ``searchsorted`` on the sorted ids,
the inverse permutation from a scatter, drops from ``where``), so the
executor's compiled step programs can hold a MoE layer.  JAX's
``custom_vmap`` wrapper of the ragged path has no counterpart: the port
does not vmap serve groups, a batch is flattened to ``[T, D]``.

Dtypes as in JAX: the router is f32 in every model; the ragged path takes
``silu(gate) * up`` in f32 and casts it to x's dtype, the sorted and dense
paths in x's dtype; every path combines in f32 and casts at the end.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = dict[str, Any]


def moe_init(gen: torch.Generator, cfg, dtype) -> Params:
    """The JAX package's distributions: a N(0, 1/d) f32 router, N(0, 1/d)
    gate and up experts, N(0, 1/f) down experts."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    scale = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=gen.device)
    return {
        "router": L.dense_init(gen, d, e, torch.float32),
        "w_gate": (normal(e, d, f) * scale).to(dtype),
        "w_up": (normal(e, d, f) * scale).to(dtype),
        "w_down": (normal(e, f, d) / math.sqrt(f)).to(dtype),
    }


def router_topk(params: Params, x: torch.Tensor, k: int, *,
                batch: bool = False):
    """Returns (expert_ids [T, k] int64, gates [T, k] f32, aux_loss scalar
    f32, the Switch-style load-balance loss kept for training).  ``batch``:
    the T tokens are a batch's, whose means are taken over every
    data-parallel rank's tokens (``layers.batch_mean``) before their
    product."""
    logits = x.float() @ params["router"]                       # [T, E]
    e = logits.shape[-1]
    gates_all = torch.softmax(logits, dim=-1)
    gates, expert_ids = torch.topk(gates_all, k, dim=-1)        # [T, k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = expert_ids.reshape(-1)
    density = torch.zeros((e,), dtype=torch.float32, device=x.device
                          ).index_add_(0, flat, torch.ones_like(
                              flat, dtype=torch.float32)) / flat.numel()
    means = torch.stack([density, gates_all.mean(dim=0)])
    if batch:
        means = L.batch_mean(means)
    aux = e * torch.sum(means[0] * means[1])
    return expert_ids, gates, aux


def capacity(t: int, k: int, e: int, factor: float = 1.25) -> int:
    return max(1, math.ceil(t * k / e * factor))


def _inverse(order: torch.Tensor) -> torch.Tensor:
    """The inverse of permutation ``order``, by a scatter."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return inv


def _combine(per_assign: torch.Tensor, gates: torch.Tensor, dtype):
    """Gate-weighted sum over the k assignments of each token, in f32."""
    return (per_assign.float() * gates[..., None]).sum(1).to(dtype)


def moe_apply_sorted(params: Params, x: torch.Tensor, *, num_experts: int,
                     k: int, capacity_factor: float = 1.25):
    """Sort-based dispatch of ``x [T, D]``.  Returns (out [T, D], aux)."""
    t, d = x.shape
    e = num_experts
    c = capacity(t, k, e, capacity_factor)
    expert_ids, gates, aux = router_topk(params, x, k)
    flat_e = expert_ids.reshape(-1)                             # [T*k]
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)                  # by expert
    e_sorted, t_sorted = flat_e[order], flat_t[order]
    # rank of each assignment within its expert group
    starts = torch.searchsorted(e_sorted, torch.arange(
        e, device=x.device, dtype=e_sorted.dtype))              # [E]
    rank = torch.arange(t * k, device=x.device) - starts[e_sorted]
    buf_idx = torch.where(rank < c, e_sorted * c + rank, e * c)  # drop: trash
    expert_in = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    expert_in[buf_idx] = x[t_sorted]
    h = expert_in[:-1].reshape(e, c, d)
    up = torch.bmm(h, params["w_up"])
    gate = torch.bmm(h, params["w_gate"])
    h2 = torch.bmm(F.silu(gate) * up, params["w_down"])
    flat_out = torch.cat([h2.reshape(e * c, d),
                          h2.new_zeros((1, d))])[buf_idx]       # [T*k, D]
    per_assign = flat_out[_inverse(order)].reshape(t, k, d)
    return _combine(per_assign, gates, x.dtype), aux


def moe_apply_sorted_rows(params: Params, x: torch.Tensor, *,
                          num_experts: int, k: int,
                          capacity_factor: float = 1.25):
    """Per-row (GShard "group") sorted dispatch of ``x [B, S, D]``: each
    row sorts and packs its own tokens, with capacity per row.  Returns
    (out [B, S, D], mean aux)."""
    outs, auxs = zip(*(moe_apply_sorted(
        params, row, num_experts=num_experts, k=k,
        capacity_factor=capacity_factor) for row in x))
    return torch.stack(outs), L.batch_mean(torch.stack(auxs).mean())


def moe_apply_ragged(params: Params, x: torch.Tensor, *, num_experts: int,
                     k: int, use_kernel: bool = True):
    """Drop-free grouped-product dispatch of ``x [T, D]`` through
    ``ops.ragged_dot``.  Returns (out [T, D], aux)."""
    t, d = x.shape
    expert_ids, gates, aux = router_topk(params, x, k, batch=True)
    flat_e = expert_ids.reshape(-1)                             # [T*k]
    order = torch.argsort(flat_e, stable=True)
    xs = x[order // k]                                          # [T*k, D]
    ends = torch.searchsorted(flat_e[order], torch.arange(
        num_experts, device=x.device, dtype=flat_e.dtype), right=True)
    group_sizes = torch.diff(ends, prepend=ends.new_zeros(1)).to(torch.int32)
    up = ops.ragged_dot(xs, params["w_up"], group_sizes,
                        use_kernel=use_kernel)
    gate = ops.ragged_dot(xs, params["w_gate"], group_sizes,
                          use_kernel=use_kernel)
    h = (F.silu(gate.float()) * up.float()).to(x.dtype)
    out_sorted = ops.ragged_dot(h, params["w_down"], group_sizes,
                                use_kernel=use_kernel)
    per_assign = out_sorted[_inverse(order)].reshape(t, k, d)
    return _combine(per_assign, gates, x.dtype), aux


def moe_apply_dense(params: Params, x: torch.Tensor, *, num_experts: int,
                    k: int):
    """O(E T) oracle: every expert computes every token; mask and
    combine.  Exact top-k, no capacity."""
    expert_ids, gates, aux = router_topk(params, x, k, batch=True)
    up = torch.einsum("td,edf->etf", x, params["w_up"])
    gate = torch.einsum("td,edf->etf", x, params["w_gate"])
    h2 = torch.einsum("etf,efd->etd", F.silu(gate) * up, params["w_down"])
    onehot = F.one_hot(expert_ids, num_experts).float()         # [T, k, E]
    weights = (onehot * gates[..., None]).sum(1)                # [T, E]
    out = torch.einsum("te,etd->td", weights, h2.float())
    return out.to(x.dtype), aux
