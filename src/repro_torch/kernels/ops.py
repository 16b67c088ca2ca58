"""Dispatch for the port's kernels.

Every function here routes by where its tensors lie: a CPU tensor goes to
the plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor
launches the hand-written kernel or raises — there is no fallback from a
failed launch.  ``use_kernel=False`` is the explicit plain-version escape
hatch (``ServeConfig.use_ref_path``), counted by the executor as
``ref_path_dispatches``.  Inputs are checked on both routes, so the CPU
path refuses what the kernel would refuse.
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
    paged_copy as _paged_copy_kernel,
    paged_copy_at as _paged_copy_at_kernel,
)
from repro_torch.kernels.paged_gather import (
    check_paged_gather,
    paged_gather as _paged_gather_kernel,
)
from repro_torch.kernels.paged_prefill_attention import (
    check_paged_prefill_attention,
    paged_prefill_attention as _paged_prefill_kernel,
)
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
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


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
    if _plain(x, use_kernel):
        check_matmul(x, y, out_dtype)
        return ref.matmul_ref(x, y, out_dtype)
    return _matmul_kernel(x, y, out_dtype=out_dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, use_kernel: bool = True):
    """Causal GQA attention, ``[B, Hq, S, D]`` in and out."""
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
    if _plain(src, use_kernel):
        check_paged_copy_at(src, pool, page_table, starts, lens, page_size)
        return ref.paged_copy_at_ref(src, pool, page_table, starts, lens,
                                     page_size=page_size)
    return _paged_copy_at_kernel(src, pool, page_table, starts, lens,
                                 page_size=page_size)


def paged_gather(pool, page_table_row, positions, *, page_size: int,
                 use_kernel: bool = True):
    """Indexed gather, one translation per element (the paper's C2 cost):
    ``pool`` rows at logical ``positions``, ``[N, W]``."""
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
    if _plain(q, use_kernel):
        check_paged_prefill_attention(q, k_pool, v_pool, page_table, starts,
                                      page_size, kv_scale)
        return ref.paged_prefill_attention_ref(
            q, k_pool, v_pool, page_table, starts, page_size=page_size,
            scale=scale, kv_scale=kv_scale)
    return _paged_prefill_kernel(
        q, k_pool, v_pool, page_table, starts, page_size=page_size,
        scale=scale, kv_scale=kv_scale)


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
