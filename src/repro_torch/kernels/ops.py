"""Dispatch for the port's kernels.

Every function here routes by where its tensors lie: a CPU tensor goes to
the plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor
launches the hand-written kernel or raises — there is no fallback from a
failed launch.  ``use_kernel=False`` is the explicit plain-version escape
hatch (``ServeConfig.use_ref_path``), counted by the executor as
``ref_path_dispatches``.  Inputs are checked on both routes, so the CPU
path refuses what the kernel would refuse.

No kernel here has a backward, as no Pallas kernel of the JAX package has
one (``jax.grad`` through one fails there).  A kernel call under grad mode
with an input that requires grad raises a ``RuntimeError`` on both routes,
instead of handing back an output cut off from the graph: training builds
its model with ``use_kernels=False`` and runs the plain versions under
autograd.  The serve entry points run under ``torch.no_grad()``, so they
never meet this check.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    check_flash_attention,
    flash_attention as _flash_kernel,
)
from repro_torch.kernels.matmul import check_matmul, matmul as _matmul_kernel
from repro_torch.kernels.paged_attention import (
    check_paged_decode_attention,
    paged_decode_attention as _paged_attn_kernel,
)
from repro_torch.kernels.paged_copy import (
    check_paged_copy,
    check_paged_copy_at,
    check_paged_copy_kv,
    check_paged_copy_kv_at,
    paged_copy as _paged_copy_kernel,
    paged_copy_at as _paged_copy_at_kernel,
    paged_copy_kv as _paged_copy_kv_kernel,
    paged_copy_kv_at as _paged_copy_kv_at_kernel,
)
from repro_torch.kernels.paged_gather import (
    check_paged_gather,
    paged_gather as _paged_gather_kernel,
)
from repro_torch.kernels.paged_prefill_attention import (
    check_paged_prefill_attention,
    paged_prefill_attention as _paged_prefill_kernel,
)
from repro_torch.kernels.ragged_dot import (
    check_ragged_dot,
    ragged_dot as _ragged_dot_kernel,
)
from repro_torch.kernels.rglru import check_rglru, rglru as _rglru_kernel
from repro_torch.kernels.wkv6 import check_wkv6, wkv6 as _wkv6_kernel
from repro_torch.kernels.wkv6_chunked import (
    CHUNK as WKV6_CHUNK,
    check_wkv6_chunked,
    wkv6_chunked as _wkv6_chunked_kernel,
)

#: the kernel wrappers whose ``launches`` counters a run reads
KERNELS = {
    "paged_copy": _paged_copy_kernel,
    "flash_attention": _flash_kernel,
    "paged_decode_attention": _paged_attn_kernel,
    "paged_copy_at": _paged_copy_at_kernel,
    "paged_prefill_attention": _paged_prefill_kernel,
    "wkv6": _wkv6_kernel,
    "wkv6_chunked": _wkv6_chunked_kernel,
    "paged_gather": _paged_gather_kernel,
    "matmul": _matmul_kernel,
    "ragged_dot": _ragged_dot_kernel,
    "rglru": _rglru_kernel,
}


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` and, where a kernel has two
    routes, its per-route ``routes`` counts."""
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict[str, dict[str, int]]:
    """Launches per route of the kernels that count them (``matmul``:
    ``matmul_route``; ``flash_attention``: ``flash_route``;
    ``paged_decode_attention``: ``decode_route``;
    ``paged_prefill_attention``: ``prefill_route``; ``paged_copy`` and
    ``paged_copy_at``: ``copy_route``; ``ragged_dot``: ``ragged_route``,
    ``"mma"`` for bf16 decode shapes, ``"wgmma"`` for bf16 prefills,
    ``"simt"`` for f32; ``paged_gather``: ``gather_route``; ``rglru``:
    ``rglru_route``, ``"step"`` for bf16 decode rows that fit its shared
    memory, ``"scan"`` otherwise)."""
    return {name: dict(fn.routes) for name, fn in KERNELS.items()
            if hasattr(fn, "routes")}


def add_launch_counts(launches: dict[str, int],
                      routes: dict[str, dict[str, int]]) -> None:
    """Add ``launches`` and per-route ``routes`` (subsets of
    :func:`launch_counts` and :func:`route_counts`) to the wrappers'
    counters: a CUDA graph's replay launches the kernels its capture
    recorded without calling the wrappers, so the executor adds them."""
    for name, n in launches.items():
        KERNELS[name].launches += n
    for name, per in routes.items():
        for route, n in per.items():
            KERNELS[name].routes[route] += n


def _refuse_grad(name: str, use_kernel: bool, *tensors) -> None:
    """Raise when a kernel call would cut its output off from autograd:
    ``use_kernel``, grad mode on and an input that requires grad."""
    if use_kernel and torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the hand-written kernel has no backward and an input "
            "requires grad; build the model with use_kernels=False for "
            "training (or call under torch.no_grad())")


def _plain(t, use_kernel: bool) -> bool:
    """True when this call takes the plain version: the tensor is on the
    CPU, or the caller asked for the plain path explicitly."""
    if not use_kernel or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def matmul(x, y, *, out_dtype=None, use_kernel: bool = True):
    """``x @ y`` with an f32 accumulator, as ``out_dtype`` (default x's
    dtype), for any ``[M, K] @ [K, N]``."""
    _refuse_grad("matmul", use_kernel, x, y)
    if _plain(x, use_kernel):
        check_matmul(x, y, out_dtype)
        return ref.matmul_ref(x, y, out_dtype)
    return _matmul_kernel(x, y, out_dtype=out_dtype)


def ragged_dot(xs, w, group_sizes, *, use_kernel: bool = True):
    """Grouped product ``xs [M, K] @ w[g(m)]`` over rows sorted by group
    (``group_sizes [E]`` int32 on xs's device), ``[M, N]`` in xs's dtype."""
    _refuse_grad("ragged_dot", use_kernel, xs, w, group_sizes)
    if _plain(xs, use_kernel):
        check_ragged_dot(xs, w, group_sizes)
        return ref.ragged_dot_ref(xs, w, group_sizes)
    return _ragged_dot_kernel(xs, w, group_sizes)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, use_kernel: bool = True):
    """Causal GQA attention, ``[B, Hq, S, D]`` in and out."""
    _refuse_grad("flash_attention", use_kernel, q, k, v)
    if _plain(q, use_kernel):
        check_flash_attention(q, k, v, causal)
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return _flash_kernel(q, k, v, causal=causal, scale=scale)


def paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens, *,
                           page_size: int, scale: float | None = None,
                           window: int | None = None,
                           kv_scale: float | None = None,
                           use_kernel: bool = True):
    """One decode step through the page table, ``[B, Hkv, G, D]``."""
    _refuse_grad("paged_decode_attention", use_kernel, q, k_pool, v_pool)
    if _plain(q, use_kernel):
        check_paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens,
                                     page_size, kv_scale, window)
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, page_table, seq_lens, page_size=page_size,
            scale=scale, window=window, kv_scale=kv_scale)
    return _paged_attn_kernel(
        q, k_pool, v_pool, page_table, seq_lens, page_size=page_size,
        scale=scale, window=window, kv_scale=kv_scale)


def paged_copy(src, pool, page_table, lens, *, page_size: int,
               use_kernel: bool = True):
    """Write ``src[b, :lens[b]]`` into ``pool`` in place; returns ``pool``."""
    _refuse_grad("paged_copy", use_kernel, src, pool)
    if _plain(src, use_kernel):
        check_paged_copy(src, pool, page_table, lens, page_size)
        return ref.paged_copy_ref(src, pool, page_table, lens,
                                  page_size=page_size)
    return _paged_copy_kernel(src, pool, page_table, lens,
                              page_size=page_size)


def paged_copy_at(src, pool, page_table, starts, lens, *, page_size: int,
                  use_kernel: bool = True):
    """Write ``src[b, :lens[b]]`` at logical positions ``starts[b]...`` of
    ``pool`` in place; returns ``pool``."""
    _refuse_grad("paged_copy_at", use_kernel, src, pool)
    if _plain(src, use_kernel):
        check_paged_copy_at(src, pool, page_table, starts, lens, page_size)
        return ref.paged_copy_at_ref(src, pool, page_table, starts, lens,
                                     page_size=page_size)
    return _paged_copy_at_kernel(src, pool, page_table, starts, lens,
                                 page_size=page_size)


def paged_copy_kv(k_src, v_src, k_pool, v_pool, page_table, lens, *,
                  page_size: int, use_kernel: bool = True):
    """:func:`paged_copy` of a layer's K and V, one launch on the card;
    returns ``(k_pool, v_pool)``."""
    _refuse_grad("paged_copy_kv", use_kernel, k_src, v_src, k_pool, v_pool)
    if _plain(k_src, use_kernel):
        check_paged_copy_kv(k_src, v_src, k_pool, v_pool, page_table, lens,
                            page_size)
        for src, pool in ((k_src, k_pool), (v_src, v_pool)):
            ref.paged_copy_ref(src, pool, page_table, lens,
                               page_size=page_size)
        return k_pool, v_pool
    return _paged_copy_kv_kernel(k_src, v_src, k_pool, v_pool, page_table,
                                 lens, page_size=page_size)


def paged_copy_kv_at(k_src, v_src, k_pool, v_pool, page_table, starts, lens,
                     *, page_size: int, use_kernel: bool = True):
    """:func:`paged_copy_at` of a layer's K and V, one launch on the card;
    returns ``(k_pool, v_pool)``."""
    _refuse_grad("paged_copy_kv_at", use_kernel, k_src, v_src, k_pool, v_pool)
    if _plain(k_src, use_kernel):
        check_paged_copy_kv_at(k_src, v_src, k_pool, v_pool, page_table,
                               starts, lens, page_size)
        for src, pool in ((k_src, k_pool), (v_src, v_pool)):
            ref.paged_copy_at_ref(src, pool, page_table, starts, lens,
                                  page_size=page_size)
        return k_pool, v_pool
    return _paged_copy_kv_at_kernel(k_src, v_src, k_pool, v_pool, page_table,
                                    starts, lens, page_size=page_size)


def paged_gather(pool, page_table_row, positions, *, page_size: int,
                 use_kernel: bool = True):
    """Indexed gather, one translation per element (the paper's C2 cost):
    ``pool`` rows at logical ``positions``, ``[N, W]``."""
    _refuse_grad("paged_gather", use_kernel, pool)
    if _plain(pool, use_kernel):
        check_paged_gather(pool, page_table_row, positions, page_size)
        return ref.paged_gather_ref(pool, page_table_row, positions,
                                    page_size=page_size)
    return _paged_gather_kernel(pool, page_table_row, positions,
                                page_size=page_size)


def paged_gather_coalesced(pool, page_table_row, positions, *,
                           page_size: int):
    """Beyond-paper: sort-coalesced indexed gather (per-PAGE translation).

    Sorting the positions turns runs within a page into single bursts, so
    the translation count drops from N to the pages touched, at the cost
    of a sort and an unpermute.  The same function as :func:`paged_gather`;
    as in the JAX package it is plain tensor code on every device (JAX
    computes it with XLA ops, no Pallas kernel)."""
    check_paged_gather(pool, page_table_row, positions, page_size)
    order = torch.argsort(positions, stable=True)
    gathered = ref.paged_gather_ref(pool, page_table_row, positions[order],
                                    page_size=page_size)
    return gathered[torch.argsort(order)]


def kernel_route(t, use_kernel: bool = True) -> bool:
    """True when a call on ``t`` launches the hand-written kernel (the
    route a counter of fetched bytes must follow)."""
    return not _plain(t, use_kernel)


def paged_prefill_attention(q, k_pool, v_pool, page_table, starts, *,
                            page_size: int, scale: float | None = None,
                            kv_scale: float | None = None,
                            use_kernel: bool = True):
    """Continuation-chunk attention through the page table,
    ``[B, S, Hkv, G, D]``."""
    _refuse_grad("paged_prefill_attention", use_kernel, q, k_pool, v_pool)
    if _plain(q, use_kernel):
        check_paged_prefill_attention(q, k_pool, v_pool, page_table, starts,
                                      page_size, kv_scale)
        return ref.paged_prefill_attention_ref(
            q, k_pool, v_pool, page_table, starts, page_size=page_size,
            scale=scale, kv_scale=kv_scale)
    return _paged_prefill_kernel(
        q, k_pool, v_pool, page_table, starts, page_size=page_size,
        scale=scale, kv_scale=kv_scale)


def rglru(conv, w_r, w_i, lam, h0, *, use_kernel: bool = True):
    """The RG-LRU of one recurrent layer: gates from ``conv [B, T, R]`` and
    ``w_r``, ``w_i [R, R]``, decay from ``lam [R]``, the recurrence from
    ``h0 [B, R]``; returns ``h [B, T, R]`` f32."""
    _refuse_grad("rglru", use_kernel, conv, w_r, w_i, lam, h0)
    if _plain(conv, use_kernel):
        check_rglru(conv, w_r, w_i, lam, h0)
        return ref.rglru_ref(conv, w_r, w_i, lam, h0)
    return _rglru_kernel(conv, w_r, w_i, lam, h0)


def wkv6_route(t: int, *, use_kernel: bool = True,
               matmul_chunks: bool = False) -> str:
    """Which computation :func:`wkv6` runs for ``t`` time steps — the rule
    of JAX ``ops.wkv6`` (``src/repro/kernels/ops.py:565-588``):

      * ``"wkv6_chunked"``: the chunked kernel, iff ``matmul_chunks and
        use_kernel and t % 32 == 0``;
      * ``"wkv6"``: the sequential kernel, for every other ``use_kernel``
        call;
      * ``"plain_chunked"``: ``use_kernel=False`` with ``matmul_chunks``,
        the chunked plain version with chunk 32;
      * ``"plain_sequential"``: ``use_kernel=False`` otherwise, the step
        loop.

    A kernel route on a CPU tensor runs that kernel's plain version."""
    if matmul_chunks and use_kernel and t % WKV6_CHUNK == 0:
        return "wkv6_chunked"
    if not use_kernel:
        return "plain_chunked" if matmul_chunks else "plain_sequential"
    return "wkv6"


def wkv6(r, k, v, w, u, initial_state=None, *, use_kernel: bool = True,
         matmul_chunks: bool = False, out_state=None):
    """RWKV-6 recurrence over ``[BH, T, N]``; returns (o, final state
    ``[BH, N, N]`` f32).  ``out_state`` receives the final state in place
    (on every route)."""
    _refuse_grad("wkv6", use_kernel, r, k, v, w, u, initial_state)
    route = wkv6_route(r.shape[1], use_kernel=use_kernel,
                       matmul_chunks=matmul_chunks)
    if not _plain(r, route in ("wkv6", "wkv6_chunked")):
        if route == "wkv6_chunked":
            return _wkv6_chunked_kernel(r, k, v, w, u, initial_state,
                                        out_state=out_state)
        return _wkv6_kernel(r, k, v, w, u, initial_state, out_state=out_state)
    if route in ("wkv6_chunked", "plain_chunked"):
        check_wkv6_chunked(r, k, v, w, u, initial_state, out_state)
        o, s = ref.wkv6_chunked_matmul_ref(r, k, v, w, u, initial_state,
                                           chunk=WKV6_CHUNK)
    else:
        check_wkv6(r, k, v, w, u, initial_state, out_state)
        o, s = ref.wkv6_ref(r, k, v, w, u, initial_state)
    if out_state is not None:
        s = out_state.copy_(s)
    return o, s


# ---------------------------------------------------------------------------
# sharded dispatch over a ('kv', 'hd') serve mesh
#
# Counterparts of JAX's ``*_sharded`` wrappers (``src/repro/kernels/
# ops.py:334-541``).  A sharded operand is a ``DTensor`` whose placements
# are the declared layout (JAX: a ``jax.Array`` with a ``NamedSharding``);
# the placements are checked, each body runs the single-device op on
# ``to_local()``, and the result is a ``DTensor`` again.  Pools and copy
# sources keep the natural 4-D layout [.., Hkv, hd] up to the boundary:
# a (kv, hd)-split pool is not a split of the merged W = Hkv * hd axis,
# so the merge to W is a reshape of the local slice, inside the body.
# Replicated operands (page table, lengths, starts) may be plain tensors,
# the same on every rank, or replicated DTensors.  The 'kv' axis needs no
# collective; on 'hd' the attention bodies all-gather the K/V pool slices
# to the full head_dim (one list ``all_gather`` of K and V together, the
# form gloo takes on CPU and CUDA tensors alike) and every 'hd' rank
# computes the same output.  The copies never gather, and write each
# rank's pool slice in place.  A mesh of one rank (or none) calls the
# unsharded op, as JAX does.
# ---------------------------------------------------------------------------


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``; a plain tensor is answered without
    importing ``torch.distributed.tensor`` (a second of start-up the
    unsharded callers never pay)."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _kv_axes(mesh, num_kv_heads: int, head_dim: int):
    # deferred, as JAX's ops.py defers it: the kernel layer does not import
    # the launcher, and only sharded callers need the rule
    from repro_torch.launch.mesh import kv_partition_axes
    return kv_partition_axes(mesh, num_kv_heads, head_dim)


def kv_layout(mesh, num_kv_heads: int, head_dim: int, kv_dim: int,
              hd_dim: int | None = None) -> tuple:
    """Placements of a KV-shaped operand: its heads (``kv_dim``) split over
    'kv' and, given ``hd_dim``, its head_dim over 'hd', each only where
    ``launch.mesh.kv_partition_axes`` lets it split."""
    kv_ax, hd_ax = _kv_axes(mesh, num_kv_heads, head_dim)
    spec = {kv_ax: kv_dim} if hd_dim is None else {kv_ax: kv_dim,
                                                   hd_ax: hd_dim}
    return placements(mesh, spec)


def placements(mesh, spec: dict) -> tuple:
    """DTensor placements of a spec ``{mesh axis: tensor dim}`` (JAX's
    ``PartitionSpec``); axes not in it (or ``None``) are replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(spec[a]) if a in spec else Replicate()
                 for a in mesh.mesh_dim_names)


def local_slice(full, mesh, layout):
    """This rank's slice of ``full`` (the same tensor on every rank) under
    ``layout``, contiguous."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    out = full
    for i, p in enumerate(layout):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(out.shape)} does "
                                 f"not split over {n} ranks")
            step = out.shape[p.dim] // n
            out = out.narrow(p.dim, coord[i] * step, step)
    return out.contiguous()


def wrap_local(local, mesh, layout, shape):
    """``local`` (this rank's slice) as a ``DTensor`` of global ``shape``
    under ``layout``, with no communication."""
    from torch.distributed.tensor import DTensor
    # the global tensor's contiguous strides, from the shape alone
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return DTensor.from_local(local, mesh, layout, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def shard_tensor(full, mesh, layout):
    """``full`` (the same tensor on every rank) as a ``DTensor`` under
    ``layout``, with no communication: each rank keeps its slice."""
    return wrap_local(local_slice(full, mesh, layout), mesh, layout,
                      full.shape)


def _gather(local, mesh, axis: str, dim: int):
    """``local`` gathered along ``dim`` over mesh ``axis`` (JAX's
    ``all_gather(..., tiled=True)``): one list ``all_gather``."""
    import torch.distributed as dist
    i = mesh.mesh_dim_names.index(axis)
    parts = [torch.empty_like(local) for _ in range(mesh.size(i))]
    dist.all_gather(parts, local.contiguous(), group=mesh.get_group(i))
    return torch.cat(parts, dim=dim)


def gather_whole(local, mesh, layout):
    """The whole tensor on every rank of ``mesh`` from each rank's slice
    ``local`` under ``layout``, in ONE ``all_gather`` over the mesh's
    ranks (``launch.mesh.mesh_group``): the slices are joined by mesh
    coordinate, along each split dim; a replicated axis keeps its first
    copy."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.launch.mesh import mesh_group
    grid = [torch.empty_like(local) for _ in range(mesh.size())]
    dist.all_gather(grid, local.contiguous(), group=mesh_group(mesh))
    # ranks 0 .. size - 1 in row-major mesh order: fold the last axis first
    for ax in reversed(range(mesh.ndim)):
        n, p = mesh.size(ax), layout[ax]
        grid = [torch.cat(grid[i:i + n], p.dim) if isinstance(p, Shard)
                else grid[i] for i in range(0, len(grid), n)]
    return grid[0]


def whole(t):
    """The whole tensor of a ``DTensor`` on every rank: its local data
    where every mesh axis replicates it, else one :func:`gather_whole`; a
    plain tensor as it is."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(t):
        return t
    if not any(isinstance(p, Shard) for p in t.placements):
        return t.to_local()
    return gather_whole(t.to_local(), t.device_mesh, t.placements)


def unshard(t):
    """The whole tensor of a ``DTensor`` on every rank (each split mesh
    axis all-gathered); a plain tensor as it is."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(t):
        return t
    out = t.to_local()
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            out = _gather(out, t.device_mesh, t.device_mesh.mesh_dim_names[i],
                          p.dim)
    return out


def _local(name: str, t, mesh, layout):
    """``t.to_local()`` after checking that ``t`` is a ``DTensor`` on
    ``mesh`` with the declared ``layout``."""
    if not is_dtensor(t):
        raise TypeError(f"{name}: a sharded operand must be a DTensor "
                        f"(placements {layout}), got {type(t).__name__}")
    if t.device_mesh != mesh or tuple(t.placements) != tuple(layout):
        raise ValueError(f"{name}: placements {tuple(t.placements)} on "
                         f"{t.device_mesh}, declared {tuple(layout)} on "
                         f"{mesh}")
    return t.to_local()


def _replicated(name: str, t):
    """A replicated operand: a plain tensor, or a DTensor that is
    replicated over every mesh axis."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(t):
        return t
    if not all(isinstance(p, Replicate) for p in t.placements):
        raise ValueError(f"{name}: must be replicated, got "
                         f"{tuple(t.placements)}")
    return t.to_local()


def _plain_mesh(mesh) -> bool:
    return mesh is None or mesh.size() == 1


def local_of(t):
    """Any tensor's local data (a one-rank mesh's DTensor holds it all)."""
    return t.to_local() if is_dtensor(t) else t


def _gather_hd(kp_l, vp_l, mesh, hd_ax):
    """K and V pool slices gathered to the full head_dim over 'hd' in one
    collective (a no-op where 'hd' does not split them)."""
    if hd_ax is None or mesh.size(mesh.mesh_dim_names.index(hd_ax)) == 1:
        return kp_l, vp_l
    both = _gather(torch.stack((kp_l, vp_l)), mesh, hd_ax, -1)
    return both[0], both[1]


def _copy_sharded(src_pools, mesh, body) -> None:
    """Hand ``body`` each (src, pool) pair merged to ``[.., W]`` views:
    on a mesh this rank's slices, checked against ``P(None, None, kv,
    hd)``; on none (or one rank) the whole tensors.  The pools are
    written in place."""
    if _plain_mesh(mesh):
        pairs = [(local_of(s), local_of(p)) for s, p in src_pools]
    else:
        src0 = src_pools[0][0]
        spec = kv_layout(mesh, src0.shape[2], src0.shape[3], 2, 3)
        pairs = [(_local("src", s, mesh, spec), _local("pool", p, mesh, spec))
                 for s, p in src_pools]
    body(*(t for s, p in pairs for t in (s.reshape(*s.shape[:2], -1),
                                         p.view(*p.shape[:2], -1))))


def paged_copy_sharded(src, pool, page_table, lens, *, page_size: int, mesh,
                       use_kernel: bool = True):
    """:func:`paged_copy` of ``src [B, S, Hkv, hd]`` into ``pool [P, page,
    Hkv, hd]``, each rank into its slice: src and pool ``P(None, None, kv,
    hd)``, page table and lens replicated; no collective.  Returns
    ``pool``, written in place."""
    pt, ln = _replicated("page_table", page_table), _replicated("lens", lens)
    _copy_sharded([(src, pool)], mesh, lambda s, p: paged_copy(
        s, p, pt, ln, page_size=page_size, use_kernel=use_kernel))
    return pool


def paged_copy_at_sharded(src, pool, page_table, starts, lens, *,
                          page_size: int, mesh, use_kernel: bool = True):
    """:func:`paged_copy_at` over the mesh (the layouts of
    :func:`paged_copy_sharded`; starts replicated).  Returns ``pool``,
    written in place."""
    pt, st = _replicated("page_table", page_table), _replicated("starts",
                                                               starts)
    ln = _replicated("lens", lens)
    _copy_sharded([(src, pool)], mesh, lambda s, p: paged_copy_at(
        s, p, pt, st, ln, page_size=page_size, use_kernel=use_kernel))
    return pool


def paged_copy_kv_sharded(k_src, v_src, k_pool, v_pool, page_table, lens, *,
                          page_size: int, mesh, use_kernel: bool = True):
    """:func:`paged_copy_kv` (a layer's K and V, one launch on the card)
    over the mesh, with :func:`paged_copy_sharded`'s layouts.  Returns
    ``(k_pool, v_pool)``, written in place."""
    pt, ln = _replicated("page_table", page_table), _replicated("lens", lens)
    _copy_sharded([(k_src, k_pool), (v_src, v_pool)], mesh,
                  lambda ks, kp, vs, vp: paged_copy_kv(
                      ks, vs, kp, vp, pt, ln, page_size=page_size,
                      use_kernel=use_kernel))
    return k_pool, v_pool


def paged_copy_kv_at_sharded(k_src, v_src, k_pool, v_pool, page_table,
                             starts, lens, *, page_size: int, mesh,
                             use_kernel: bool = True):
    """:func:`paged_copy_kv_at` over the mesh, with
    :func:`paged_copy_at_sharded`'s layouts.  Returns ``(k_pool,
    v_pool)``, written in place."""
    pt, st = _replicated("page_table", page_table), _replicated("starts",
                                                               starts)
    ln = _replicated("lens", lens)
    _copy_sharded([(k_src, k_pool), (v_src, v_pool)], mesh,
                  lambda ks, kp, vs, vp: paged_copy_kv_at(
                      ks, vs, kp, vp, pt, st, ln, page_size=page_size,
                      use_kernel=use_kernel))
    return k_pool, v_pool


def _attention_sharded(q, k_pool, v_pool, mesh, heads_dim: int, op):
    """The body of the paged attention wrappers: q and the output split
    over 'kv' on ``heads_dim``, pools ``P(None, None, kv, hd)`` gathered
    over 'hd'; ``op(q_l, kp, vp)`` is the single-device call (on the
    whole tensors where there is no mesh, or one rank)."""
    if _plain_mesh(mesh):
        return op(*map(local_of, (q, k_pool, v_pool)))
    kv_ax, hd_ax = _kv_axes(mesh, q.shape[heads_dim], q.shape[-1])
    q_spec = placements(mesh, {kv_ax: heads_dim})
    pool_spec = placements(mesh, {kv_ax: 2, hd_ax: 3})
    q_l = _local("q", q, mesh, q_spec)
    kp_l, vp_l = _gather_hd(_local("k_pool", k_pool, mesh, pool_spec),
                            _local("v_pool", v_pool, mesh, pool_spec),
                            mesh, hd_ax)
    return wrap_local(op(q_l, kp_l, vp_l), mesh, q_spec, q.shape)


def paged_decode_attention_sharded(q, k_pool, v_pool, page_table, seq_lens,
                                   *, page_size: int, mesh,
                                   scale: float | None = None,
                                   window: int | None = None,
                                   kv_scale: float | None = None,
                                   use_kernel: bool = True):
    """:func:`paged_decode_attention` on each rank's slice: q ``[B, Hkv,
    G, D]`` and the output ``P(None, kv, None, None)``, pools ``P(None,
    None, kv, hd)`` (all-gathered over 'hd' in the body), page table and
    lengths replicated."""
    pt = _replicated("page_table", page_table)
    ln = _replicated("seq_lens", seq_lens)
    return _attention_sharded(
        q, k_pool, v_pool, mesh, 1,
        lambda q_l, kp, vp: paged_decode_attention(
            q_l, kp, vp, pt, ln, page_size=page_size, scale=scale,
            window=window, kv_scale=kv_scale, use_kernel=use_kernel))


def paged_prefill_attention_sharded(q, k_pool, v_pool, page_table, starts, *,
                                    page_size: int, mesh,
                                    scale: float | None = None,
                                    kv_scale: float | None = None,
                                    use_kernel: bool = True):
    """:func:`paged_prefill_attention` over the mesh: q ``[B, S, Hkv, G,
    D]`` and the output ``P(None, None, kv, None, None)``, pools ``P(None,
    None, kv, hd)`` (gathered over 'hd'), page table and starts
    replicated."""
    pt, st = _replicated("page_table", page_table), _replicated("starts",
                                                               starts)
    return _attention_sharded(
        q, k_pool, v_pool, mesh, 2,
        lambda q_l, kp, vp: paged_prefill_attention(
            q_l, kp, vp, pt, st, page_size=page_size, scale=scale,
            kv_scale=kv_scale, use_kernel=use_kernel))


def flash_attention_sharded(q, k, v, *, mesh, causal: bool = True,
                            scale: float | None = None,
                            use_kernel: bool = True):
    """:func:`flash_attention` with heads split over 'kv': q ``[B, Hq, S,
    D]`` (kv-major heads, Hq = Hkv * G), k and v ``[B, Hkv, S, D]`` and the
    output all ``P(None, kv, None, None)``; D is the contraction and stays
    whole, so there is no collective."""
    if _plain_mesh(mesh):
        return flash_attention(*map(local_of, (q, k, v)), causal=causal,
                               scale=scale, use_kernel=use_kernel)
    spec = kv_layout(mesh, k.shape[1], q.shape[3], 1)
    out = flash_attention(*(_local(n, t, mesh, spec) for n, t in
                            (("q", q), ("k", k), ("v", v))),
                          causal=causal, scale=scale, use_kernel=use_kernel)
    return wrap_local(out, mesh, spec, q.shape)
