"""Operation-level cost of one step, counted as it dispatches (the port's
counterpart of ``src/repro/launch/hlo_cost.py``).

:func:`analyze` runs ``fn(*args)`` once under a ``TorchDispatchMode`` and
returns JAX's ``analyze`` dict: ``flops``, ``bytes``,
``collective_bytes``, ``collective_bytes_by_kind``,
``collective_counts``, ``bytes_by_scope`` and ``flops_by_scope``, per
rank.  On ``meta`` tensors over a fake process group (the dry-run) nothing
is computed or sent; the counts come from the shapes.  JAX's conventions
(``hlo_cost.py:1-21``), restated for aten operations:

  * FLOPs: a matmul-like op (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    convolutions, fused attention) by ``torch.utils.flop_counter``'s
    formulas: 2 x prod(out) x the contracted size; each arithmetic
    elementwise op (:data:`_ELEMENTWISE`: JAX's arithmetic opcodes, their
    fused aten forms such as ``silu`` or ``_softmax`` and autograd's
    ``*_backward`` of them), reduction, sort and scatter adds prod(out).
    A ``where``, a copy or an index adds none, as a ``select`` adds none in
    JAX.
  * bytes: each op counts its operands and its output; views (an
    overload whose output aliases an input), ``detach`` and factories
    (no tensor operand, or a ``new_*`` / ``*_like`` op) are free.  JAX's
    TPU rules are kept: a convert or copy of as many elements as its
    operand (``_to_copy``, ``copy_``, ``clone``) is free; a gather
    (``index``, ``index_select``, ``gather``, ``embedding``) counts twice
    its output plus its operands smaller than that; a scatter
    (``index_put``, ``scatter*``, ``index_add``, ``index_copy``,
    ``embedding_dense_backward``) counts twice its operands less the
    buffer it updates in place.
  * collectives: each c10d collective (``c10d.*`` as ``torch.distributed``
    calls it, ``_c10d_functional.*`` as DTensor calls it) counts its
    output, the bytes a rank receives (all-gather: the gathered tensor,
    own slice included; all-reduce: the tensor), under JAX's kind names,
    and adds them to ``bytes`` too.  ``step.comm`` of the mesh train step
    counts an all-gather as ``(n - 1) / n`` of this (a rank's own slice is
    not received) and a gradient's all-reduce as this, and leaves out the
    all-reduces of the step's statistics (:func:`stat_bytes`).  So, for
    a step whose all-gathers span its mesh of ``n`` ranks,
    ``collective_bytes_by_kind["all-gather"] * (n - 1) / n ==
    comm["gathered"]`` and ``collective_bytes_by_kind["all-reduce"] ==
    comm["reduced"] + stat_bytes(...)``.
  * scopes: JAX's ``_SCOPE_BUCKETS`` keywords matched against the path of
    port functions on the Python stack, outermost first, and the aten op's
    name (JAX matches its ``op_name`` metadata, which is that path);
    autograd's ops go to ``"backward"``.  The DTensor layout helpers of
    ``kernels.ops`` (:data:`_PLUMBING`) are left out of the path: their
    copies complete a collective, which JAX does not scope.
  * loops: eager dispatch sees every trip of every Python loop over
    layers, so JAX's trip-count machinery (``known_trip_count``, the
    condition's constants) has no counterpart.
  * the plain versions do work a kernel would not do, and are counted as
    they dispatch, with one exception: ``ref.ragged_dot_ref`` multiplies
    every row by every expert (E x the work), so a call of it counts as
    ``ragged_dot`` does, 2·M·K·N FLOPs and its operands and output once.
    The plain causal attention counts its whole S x S product (a kernel
    skips the masked half), and the plain paged attention reads the page
    table's whole reach, each as it dispatches.

A ``DTensor`` op is let through (``NotImplemented``) so that the mode sees
the local ops and the collectives DTensor dispatches: every count is a
rank's.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass_type)
from torch.utils._pytree import tree_flatten

#: coarse buckets for scope attribution (JAX's ``hlo_cost._SCOPE_BUCKETS``)
_SCOPE_BUCKETS = (
    ("attention", ("bhgqd", "bhgqk", "bhkd", "attention", "flash", "paged")),
    ("moe", ("ragged_dot", "moe", "top_k", "expert")),
    ("optimizer", ("adamw", "transpose(jvp", "sqrt", "optimizer")),
    ("embedding", ("embed", "take", "gather")),
    ("loss", ("logsumexp", "xent", "log_softmax")),
)


def scope_bucket(op_name: str) -> str:
    """JAX's ``hlo_cost.scope_bucket``: the first bucket one of whose
    keywords ``op_name`` holds; ``"transpose(jvp"`` is the backward."""
    low = op_name.lower()
    if "transpose(jvp" in low:
        return "backward"
    for bucket, keys in _SCOPE_BUCKETS:
        if any(k in low for k in keys):
            return bucket
    return "other"


#: JAX's arithmetic opcodes by their aten names, the fused forms the port
#: dispatches, autograd's backward ops of them, reductions, sorts, scans
#: and scatters: each adds prod(out) FLOPs
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "pow", "exp", "exp2", "log",
    "log1p", "log2", "tanh", "rsqrt", "sqrt", "maximum", "minimum", "neg",
    "abs", "expm1", "sigmoid", "cos", "sin", "reciprocal", "square", "erf",
    "silu", "gelu", "softplus", "relu", "addcmul", "addcdiv", "lerp",
    "clamp", "clamp_min", "clamp_max", "_softmax", "_log_softmax",
    "logsumexp", "sum", "mean", "amax", "amin", "max", "min", "prod", "var",
    "var_mean", "std", "norm", "linalg_vector_norm", "argmax", "argmin",
    "sort", "topk", "cumsum", "cumprod", "logcumsumexp", "scatter",
    "scatter_add", "scatter_reduce", "index_add", "silu_backward",
    "gelu_backward", "tanh_backward", "sigmoid_backward",
    "threshold_backward", "softplus_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
})
#: gathers: twice the output plus the operands smaller than it
_GATHERS = frozenset({"index", "index_select", "gather", "embedding",
                      "take"})
#: scatters: twice the operands less the buffer updated in place
_SCATTERS = frozenset({"index_put", "_index_put_impl", "scatter",
                       "scatter_add", "scatter_reduce", "index_add",
                       "index_copy", "slice_scatter", "select_scatter",
                       "masked_scatter", "embedding_dense_backward"})
#: converts and copies: free when they keep the element count
_CONVERTS = frozenset({"_to_copy", "copy", "clone", "_copy_from",
                       "_copy_from_and_resize"})
_FREE = frozenset({"detach", "alias", "lift_fresh", "lift_fresh_copy",
                   "empty", "empty_strided", "empty_like", "zeros",
                   "zeros_like", "ones", "ones_like", "full", "full_like",
                   "arange", "scalar_tensor", "rand", "rand_like", "randn",
                   "randn_like", "new_empty", "new_empty_strided",
                   "new_zeros", "new_ones", "new_full", "wait_tensor"})
#: collectives by aten packet name, under JAX's kind names
_COLLECTIVES = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
#: the DTensor layout helpers of ``kernels.ops``, left out of scope paths
_PLUMBING = frozenset({"whole", "gather_whole", "unshard", "_gather",
                       "local_slice", "shard_tensor", "wrap_local",
                       "local_of", "_local", "_replicated"})


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ragged_dot_cost(xs, w, group_sizes) -> tuple[float, float]:
    """``ragged_dot``'s FLOPs and bytes: 2·M·K·N, and each operand and the
    output ``[M, N]`` once."""
    m, k = xs.shape
    n = w.shape[2]
    out = m * n * xs.element_size()
    return (2.0 * m * k * n,
            float(_nbytes(xs) + _nbytes(w) + _nbytes(group_sizes) + out))


def _regions() -> dict:
    """Code objects of the plain versions counted by a formula, with the
    formula of their arguments."""
    from repro_torch.kernels import ref
    return {ref.ragged_dot_ref.__code__: (
        lambda loc: _ragged_dot_cost(loc["xs"], loc["w"],
                                     loc["group_sizes"]))}


@dataclasses.dataclass
class Costs:
    """A rank's counts (JAX's ``hlo_cost.Costs``), plus the FLOPs of the
    matmul-like ops alone."""
    flops: float = 0.0
    bytes: float = 0.0
    matmul_flops: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    bytes_by_scope: dict = dataclasses.field(default_factory=dict)
    flops_by_scope: dict = dataclasses.field(default_factory=dict)

    def tag(self, scope: str, flops: float, nbytes: float) -> None:
        self.bytes_by_scope[scope] = self.bytes_by_scope.get(scope, 0) + nbytes
        self.flops_by_scope[scope] = self.flops_by_scope.get(scope, 0) + flops

    def as_dict(self) -> dict:
        """JAX's ``analyze`` dict."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.coll_bytes,
            "collective_bytes_by_kind": {
                k: float(v) for k, v in self.coll_by_kind.items()},
            "collective_counts": {
                k: float(v) for k, v in self.coll_counts.items()},
            "bytes_by_scope": {
                k: float(v) for k, v in self.bytes_by_scope.items()},
            "flops_by_scope": {
                k: float(v) for k, v in self.flops_by_scope.items()},
        }


class CostMode(TorchDispatchMode):
    """Counts every op dispatched inside it into :attr:`costs`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.costs = Costs()
        self._formulas = flop_registry
        self._regions = _regions()
        self._region_frame = None

    def __exit__(self, *exc):
        self._region_frame = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_traceable_wrapper_subclass_type(t) for t in types):
            # DTensor (and funcol's async wrapper) first: the mode then
            # sees the local ops and the collectives they dispatch
            return NotImplemented
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.costs
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return
            got = out if func.namespace != "c10d" else args[0]
            b = sum(_nbytes(t) for t in _tensors(got))
            c.coll_bytes += b
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0) + b
            c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
            c.bytes += b
            return
        ins = _tensors((args, kwargs))
        if func.is_view or name in _FREE or not ins:
            return
        outs = _tensors(out)
        path, region = self._stack()
        if region is not None:
            frame, formula = region
            if frame is not self._region_frame:
                self._region_frame = frame
                flops, nbytes = formula(frame.f_locals)
                self._add(path, name, flops, nbytes, matmul=True)
            return
        base = name.rstrip("_")
        in_b = [_nbytes(t) for t in ins]
        out_b = sum(_nbytes(t) for t in outs)
        if base in _CONVERTS and any(
                t.numel() == o.numel() for t in ins for o in outs):
            return
        matmul = func._overloadpacket in self._formulas
        if matmul:
            flops = float(self._formulas[func._overloadpacket](
                *args, **kwargs, out_val=out))
        elif base in _ELEMENTWISE:
            flops = float(sum(o.numel() for o in outs))
        else:
            flops = 0.0
        if base in _GATHERS:
            nbytes = 2 * out_b + sum(b for b in in_b if b < out_b)
        elif base in _SCATTERS:
            big = max(in_b)
            nbytes = 2 * (sum(in_b) - (big if big >= out_b else 0))
        else:
            nbytes = out_b + sum(in_b)
        self._add(path, name, flops, float(nbytes), matmul=matmul)

    def _add(self, path: str, name: str, flops: float, nbytes: float, *,
             matmul: bool) -> None:
        c = self.costs
        c.flops += flops
        c.bytes += nbytes
        if matmul:
            c.matmul_flops += flops
        if torch._C._current_autograd_node() is not None:
            scope = "backward"
        else:
            scope = scope_bucket(f"{path}/{name}")
        c.tag(scope, flops, nbytes)

    def _stack(self):
        """(the path of port functions on the stack, outermost first;
        the innermost frame of a formula-counted plain version and its
        formula, or None)."""
        names, region = [], None
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            hit = self._regions.get(code)
            if hit is not None:
                region = (f, hit)
            mod = f.f_globals.get("__name__", "")
            if (mod.startswith("repro_torch.") and mod != __name__
                    and code.co_name not in _PLUMBING):
                names.append(code.co_qualname)
            f = f.f_back
        return "/".join(reversed(names)), region


def count(fn: Callable, *args: Any) -> tuple[Costs, Any]:
    """``fn(*args)`` once under :class:`CostMode`: (its :class:`Costs`,
    its result)."""
    mode = CostMode()
    with mode:
        out = fn(*args)
    return mode.costs, out


def analyze(fn: Callable, *args: Any) -> dict:
    """JAX's ``hlo_cost.analyze`` dict of one call of ``fn(*args)``."""
    return count(fn, *args)[0].as_dict()


def stat_bytes(n_moe_layers: int) -> int:
    """The bytes of a mesh train step's statistics' all-reduces, which
    ``step.comm["reduced"]`` leaves out, where the batch splits over one
    data-parallel axis: the loss's two sums and one router statistic a
    MoE layer over it, then the clipping norm over the mesh; f32 each."""
    return 4 * (2 + n_moe_layers + 1)


def tree_bytes(tree: Any) -> int:
    """The bytes of every tensor of ``tree`` on this rank (a DTensor's
    local slice), each tensor once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t.to_local() if hasattr(t, "to_local") else t)
    return total
