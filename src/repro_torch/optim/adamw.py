"""AdamW with a warmup-cosine schedule and global-norm clipping (port of
``src/repro/optim/adamw.py``).

Plain functions over parameter trees (nested dicts and lists of tensors,
as the port's models keep them); they return new trees and change none
they are given.  The arithmetic and casts are JAX's, not
``torch.optim.AdamW``'s (whose decoupled decay rounds differently):

  * the clip scale ``min(1, clip_norm / max(norm, 1e-9))`` is f32, cast to
    each gradient's dtype before the product;
  * the learning rate and the bias corrections ``1 - b ** step`` are f32;
  * ``p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)`` in f32, cast back to
    the parameter's dtype; the moments are stored in their own dtype
    (f32, or bf16 under ``moment_dtype="bfloat16"``).

Sharded trees (``DTensor`` leaves, laid out by ``launch.sharding``) are
updated shard by shard: each rank steps its local slices, and the global
norm sums each rank's local squares over the mesh, counting a slice that
is replicated over a mesh axis once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import local_of as local


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the congruent ``rest``, in
    :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        children = [tree_map(fn, v, *(r[i] for r in rest))
                    for i, v in enumerate(tree)]
        # a NamedTuple (``AdamWState``) takes its fields as arguments
        return (type(tree)(*children) if hasattr(tree, "_fields")
                else type(tree)(children))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree``, dict keys in sorted order and a
    ``NamedTuple``'s in field order (``jax.tree``'s)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves) -> Any:
    """``leaves`` (in :func:`tree_leaves`' order) in the shape of
    ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def like(x: torch.Tensor, new_local: torch.Tensor) -> torch.Tensor:
    """``new_local`` laid out as ``x`` is: a ``DTensor`` of ``x``'s mesh,
    placements and global shape where ``x`` is one, else itself."""
    if not ops.is_dtensor(x):
        return new_local
    return ops.wrap_local(new_local, x.device_mesh, x.placements, x.shape)


class AdamWState(NamedTuple):
    step: torch.Tensor       # scalar int32
    m: Any                   # tree like params
    v: Any                   # tree like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    base_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    #: moment dtype: "bfloat16" halves the optimizer's memory
    moment_dtype: str = "float32"


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def adamw_init(params: Any, moment_dtype: str = "float32") -> AdamWState:
    """Zero moments like ``params`` in ``moment_dtype``, step 0."""
    dt = _MOMENT_DTYPES[moment_dtype]
    leaf = tree_leaves(params)[0]

    def zeros(p):
        x = local(p)
        return like(p, torch.zeros(x.shape, dtype=dt, device=x.device))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=local(leaf).device),
        m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr_frac * base_lr`` at ``total_steps``; f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    floor = cfg.min_lr_frac
    return cfg.base_lr * warm * (floor + (1 - floor) * cos)


def _first_copy(x) -> bool:
    """Whether this rank's slice of ``DTensor`` ``x`` is the one counted:
    coordinate 0 on every mesh axis that replicates it."""
    from torch.distributed.tensor import Shard
    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, x.placements)
               if not isinstance(p, Shard))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32.  A tree of
    ``DTensor`` leaves (all on one mesh) counts each distinct slice once:
    the local squares of the slices each rank counts, summed over the
    mesh in one all-reduce."""
    leaves = tree_leaves(tree)
    sharded = [ops.is_dtensor(x) for x in leaves]
    if not any(sharded):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    if not all(sharded):
        raise ValueError("global_norm: a tree of DTensors and plain "
                         "tensors; lay every leaf out on the mesh")
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_group
    total = sum(torch.sum(torch.square(local(x).float())) if _first_copy(x)
                else local(x).new_zeros((), dtype=torch.float32)
                for x in leaves)
    dist.all_reduce(total, group=mesh_group(leaves[0].device_mesh))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float):
    """Returns (grads scaled to a global norm of at most ``max_norm``, the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: like(g, local(g) * scale.to(g.dtype)),
                    grads), norm


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 cfg: AdamWConfig):
    """One AdamW step.  Returns (new params, new state, {"lr",
    "grad_norm"}); grads may be low precision.  Sharded trees step each
    rank's slices; ``params``, ``grads`` and the moments share a layout."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = local(state.step) + 1
    lr = cosine_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    new_p, new_m, new_v = [], [], []

    def upd(p_, g_, m_, v_):
        p, g, m, v = local(p_), local(g_), local(m_), local(v_)
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        update = update + cfg.weight_decay * p.float()
        p_new = p.float() - lr * update
        new_p.append(like(p_, p_new.to(p.dtype)))
        new_m.append(like(m_, m_new.to(m.dtype)))
        new_v.append(like(v_, v_new.to(v.dtype)))

    tree_map(upd, params, grads, state.m, state.v)
    return (tree_unflatten(params, new_p),
            AdamWState(like(state.step, step), tree_unflatten(params, new_m),
                       tree_unflatten(params, new_v)),
            {"lr": lr, "grad_norm": gnorm})
