"""Sharding rules: parameters (TP + FSDP), optimizer state (ZeRO), batches,
activations (port of ``src/repro/launch/sharding.py``).

The rules are JAX's, line for line, as pure functions of a leaf's path
names, its shape and the mesh's ``{axis name: extent}``:

  * TP over ``model``: per-role dimension (head projections, FFN hidden,
    expert index, vocabulary);
  * FSDP over ``data`` (never across pods): the largest remaining
    dimension that divides the data axis;
  * batches over the data-parallel axes (``pod``, ``data``), the
    ``[3, B, S]`` M-RoPE positions on dim 1;
  * activations: batch over the data-parallel axes, sequence over
    ``model`` between blocks (the shard hook).

Every rule degrades to replicated where a dimension does not divide its
axis.  A spec has the form of JAX's ``PartitionSpec``: a tuple with one
entry per dim, each ``None``, an axis name or a tuple of axis names.

The port keeps one dict per layer (``params["blocks"][i]``, RG-LRU's
``params["layers"][i]``) where JAX stacks a leading layer dim under
``blocks`` / ``supers`` / ``tail``.  A per-layer leaf gets JAX's spec for
the stacked leaf with that leading ``None`` dropped.

On a ``DeviceMesh`` a spec becomes DTensor placements
(:class:`NamedSharding`): ``Shard(d)`` on each mesh dim whose axis the
spec puts on tensor dim ``d``.  Two axes on one dim (``("data",
"model")``, ``("kv", "hd")``) split it in the mesh's dim order, which is
the tuple's order only where the tuple follows the mesh's dim order; a
spec that does not raises.

The tree functions return trees of :class:`NamedSharding` congruent with
their input; the training step reads them as ``grad_shardings`` and the
``Trainer`` / ``checkpoint.restore`` lay trees out with them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.launch.mesh import mesh_extents
from repro_torch.optim.adamw import AdamWState, tree_map

# role -> which dim gets the `model` axis (after the stacked-layer dim is
# stripped).  Everything else: biases, norms, scalars -> replicated.
_MODEL_DIM_BY_NAME: dict[str, int] = {
    # [in, out]-style projections: shard the output (hidden/head) dim
    "wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1, "wg": 1,
    "wr": 1, "wi": 1, "w_x": 1, "w_i": 1,
    # output projections: shard the input dim (row-parallel)
    "wo": 0, "w_down": 0, "w_out": 0,
    # embeddings / heads: vocab-parallel
    "embed": 0, "head": 1,
    # moe experts [E, D, F]: expert-parallel
    "w_gate_moe": 0, "w_up_moe": 0, "w_down_moe": 0,
}

#: the roots whose leaves are one layer each: JAX's stacked roots, and
#: the port's flattened RG-LRU layers
PER_LAYER_ROOTS = ("blocks", "supers", "tail", "layers")


def dp_axes_of(extents: dict[str, int]) -> tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') or ('data',)."""
    return tuple(a for a in extents if a in ("pod", "data"))


def _entry(axes: tuple[str, ...]):
    """A spec entry of ``axes`` in ``PartitionSpec``'s normal form: None,
    one axis name, or a tuple of two or more."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def spec_for(names, shape, extents: dict[str, int], use_fsdp: bool = True,
             model_axes: tuple[str, ...] = ("model",)) -> tuple:
    """JAX's ``_spec_for`` of the leaf at path ``names`` (dict keys and
    list indices as strings) of ``shape`` on a mesh of ``extents``; a
    per-layer leaf (under :data:`PER_LAYER_ROOTS`) is read as JAX's
    stacked leaf, and its spec returned without the stacked dim."""
    names = [str(n) for n in names]
    stacked = int(names[0] in PER_LAYER_ROOTS)
    shape = (1,) * stacked + tuple(shape)
    leaf = names[-1]
    msize = 1
    for a in model_axes:
        msize *= extents[a]
    model_assign = model_axes if len(model_axes) > 1 else model_axes[0]
    fsdp = "data" if (use_fsdp and "data" in extents) else None
    fsize = extents[fsdp] if fsdp else 1

    dims: list[Any] = [None] * len(shape)

    def out():
        return tuple(dims[stacked:])

    if len(shape) - stacked < 1 or leaf in ("scale", "lam", "w0", "u",
                                            "conv_w", "mu", "ln_x"):
        return out()
    is_moe = any(n == "mlp" for n in names) and len(shape) - stacked == 3
    key = leaf + "_moe" if (is_moe and leaf in ("w_gate", "w_up", "w_down")) \
        else leaf
    model_dim = _MODEL_DIM_BY_NAME.get(key)
    if key.startswith("mu_") or key.startswith("b"):
        return out()
    if model_dim is None:
        # unknown 2D+ leaf: try FSDP on the largest dim only
        model_dim = -1
    if model_dim >= 0:
        d = model_dim + stacked
        if is_moe and not use_fsdp and d < len(shape):
            # serving MoE: the expert dim over data x model axes too,
            # the largest divisible combination
            for combo in (("data",) + model_axes, ("data", model_axes[0]),
                          model_axes, (model_axes[0],)):
                prod = 1
                for a in combo:
                    prod *= extents.get(a, 1)
                if shape[d] % prod == 0:
                    dims[d] = combo if len(combo) > 1 else combo[0]
                    break
            # remaining per-expert dims: spread leftover model axes on F
            if (isinstance(dims[d], tuple) and "data" in dims[d]
                    and len(dims[d]) < 1 + len(model_axes)):
                rest = tuple(a for a in model_axes if a not in dims[d])
                for dd in range(len(shape) - 1, stacked, -1):
                    if dims[dd] is None and rest:
                        prod = 1
                        for a in rest:
                            prod *= extents[a]
                        if shape[dd] % prod == 0:
                            dims[dd] = rest if len(rest) > 1 else rest[0]
                            break
        elif d < len(shape) and shape[d] % msize == 0:
            dims[d] = model_assign
    # embed/head with an indivisible vocab: their only shardable dim is the
    # contraction dim; replicate them instead (JAX's rule)
    if leaf in ("embed", "head") and all(d is None for d in dims):
        return out()
    if fsdp:
        cands = [i for i in range(stacked, len(shape))
                 if dims[i] is None and shape[i] % fsize == 0
                 and shape[i] >= fsize]
        if cands:
            best = max(cands, key=lambda i: shape[i])
            dims[best] = fsdp
    return out()


def batch_spec_for(names, ndim: int, extents: dict[str, int]) -> tuple:
    """A batch leaf's spec: dim 0 over the data-parallel axes; the
    ``[3, B, S]`` positions on dim 1."""
    dp = _entry(dp_axes_of(extents))
    if names and str(names[-1]) == "positions" and ndim == 3:
        return (None, dp) + (None,) * (ndim - 2)
    return (dp,) + (None,) * (ndim - 1)


def serve_spec_for(shape, extents: dict[str, int]) -> tuple:
    """A serving tree's leaf spec: the leading data-group axis G over
    'data' (G > 1), and the last dim of a pool-like leaf (5-D or more)
    over 'model' where it divides."""
    dims: list[Any] = [None] * len(shape)
    if shape and shape[0] > 1:
        dims[0] = "data"
    if len(shape) >= 5 and shape[-1] % extents["model"] == 0:
        dims[-1] = "model"
    return tuple(dims)


def activation_spec(extents: dict[str, int], name: str, shape, *,
                    sequence_parallel: bool = True) -> tuple | None:
    """The shard hook's spec for an activation ``name`` of ``shape``, or
    None where the hook leaves it as it is."""
    dp = _entry(dp_axes_of(extents))
    msize = extents["model"]
    nd = len(shape)
    if name == "act_btd_nosp" and nd == 3:
        return (dp, None, None)
    if name == "act_btd" and nd == 3:
        seq = "model" if (sequence_parallel
                          and shape[1] % msize == 0) else None
        return (dp, seq, None)
    if name == "logits" and nd >= 2:
        return (dp,) + (None,) * (nd - 2) + (
            "model" if shape[-1] % msize == 0 else None,)
    return None


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------


def spec_placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (``ops.placements`` of
    ``{axis: the dim the spec puts it on}``): ``Shard(d)`` on every mesh
    dim whose axis the spec puts on tensor dim ``d``, ``Replicate()`` on
    the others.  A dim with several axes must list them in the mesh's dim
    order; an axis the mesh lacks, or used twice, raises."""
    from repro_torch.kernels import ops
    names = list(mesh.mesh_dim_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{tuple(names)}")
            if a in where:
                raise ValueError(f"spec {spec}: axis {a!r} used twice")
            where[a] = d
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: dim {d} lists {axes}, against the mesh's dim "
                f"order {tuple(names)}; DTensor splits a dim in mesh order")
    return ops.placements(mesh, where)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on a ``DeviceMesh`` (JAX's ``NamedSharding``): its
    ``spec`` and the DTensor ``placements`` it gives."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)


def _paths(tree: Any, fn, path=()) -> Any:
    """``fn(path names, leaf)`` over a tree of dicts, lists and tuples
    (a ``NamedTuple`` rebuilt as such)."""
    if isinstance(tree, dict):
        return {k: _paths(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [_paths(v, fn, path + (str(i),))
                    for i, v in enumerate(tree)]
        return (type(tree)(*children) if hasattr(tree, "_fields")
                else type(tree)(children))
    return fn(path, tree)


def param_shardings(params: Any, mesh, use_fsdp: bool = True,
                    model_axes: tuple[str, ...] = ("model",)) -> Any:
    """A tree of :class:`NamedSharding` congruent with ``params`` (tensors,
    on ``meta`` for shapes only).  ``use_fsdp=False`` (serving): TP over
    the model axes only; ``model_axes``: the serve mesh's ('kv', 'hd')."""
    ext = mesh_extents(mesh)
    return _paths(params, lambda names, x: NamedSharding(mesh, spec_for(
        names, tuple(x.shape), ext, use_fsdp, model_axes)))


def opt_shardings(params: Any, mesh) -> AdamWState:
    """AdamW's state: the step replicated, both moments in the parameters'
    layout (ZeRO-3: the parameters are fully sharded already)."""
    p_sh = param_shardings(params, mesh)
    return AdamWState(step=NamedSharding(mesh, ()), m=p_sh, v=p_sh)


def batch_shardings(batch: Any, mesh) -> Any:
    """The batch dim over the data-parallel axes; positions ``[3, B, S]``
    on dim 1."""
    ext = mesh_extents(mesh)
    return _paths(batch, lambda names, x: NamedSharding(
        mesh, batch_spec_for(names, len(x.shape), ext)))


def serve_shardings(tree: Any, mesh) -> Any:
    """Serving trees with a leading data-group axis G on every leaf."""
    ext = mesh_extents(mesh)
    return _paths(tree, lambda names, x: NamedSharding(
        mesh, serve_spec_for(tuple(x.shape), ext)))


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` (the same whole tensor on every rank) as a
    ``DTensor`` under its sharding, with no communication: each rank keeps
    its slice."""
    from repro_torch.kernels import ops
    return tree_map(lambda x, s: ops.shard_tensor(x, s.mesh, s.placements),
                    tree, shardings)


def make_shard_hook(mesh, *, sequence_parallel: bool = True):
    """The models' activation hook ``shard(x, name)``: a ``DTensor`` is
    redistributed to :func:`activation_spec`'s layout (JAX's
    ``with_sharding_constraint``); a plain tensor is returned as it is,
    since the port's mesh step computes on whole tensors."""
    ext = mesh_extents(mesh)

    def shard(x: torch.Tensor, name: str) -> torch.Tensor:
        from repro_torch.kernels import ops
        if not ops.is_dtensor(x):
            return x
        spec = activation_spec(ext, name, tuple(x.shape),
                               sequence_parallel=sequence_parallel)
        if spec is None:
            return x
        return x.redistribute(mesh, spec_placements(mesh, spec))

    return shard


def dp_spec(mesh):
    """The spec entry of the mesh's data-parallel axes (JAX's ``dp``)."""
    return _entry(dp_axes_of(mesh_extents(mesh)))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card on a cuda mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
