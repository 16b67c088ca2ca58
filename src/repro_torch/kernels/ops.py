"""Dispatch for the serve-path kernels.

Every function here routes by where its tensors lie: a CPU tensor goes to
the plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor
launches the hand-written kernel or raises — there is no fallback from a
failed launch.  ``use_kernel=False`` is the explicit plain-version escape
hatch (``ServeConfig.use_ref_path``), counted by the executor as
``ref_path_dispatches``.  Inputs are checked on both routes, so the CPU
path refuses what the kernel would refuse.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    check_flash_attention,
    flash_attention as _flash_kernel,
)
from repro_torch.kernels.paged_attention import (
    check_paged_decode_attention,
    paged_decode_attention as _paged_attn_kernel,
)
from repro_torch.kernels.paged_copy import (
    check_paged_copy,
    paged_copy as _paged_copy_kernel,
)

#: the kernel wrappers whose ``launches`` counters a run reads
KERNELS = {
    "paged_copy": _paged_copy_kernel,
    "flash_attention": _flash_kernel,
    "paged_decode_attention": _paged_attn_kernel,
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
