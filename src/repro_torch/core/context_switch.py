"""Context switches: saving/restoring vector state under preemption.

AraOS §3.1: a context switch between two vector processes saves and restores
the vector state (VRF + vector CSRs) at memory bandwidth — ~3.2 k cycles for
an 8-KiB VRF over a 64-bit/cycle path (vs ~1 k cycles scalar-only).

Serving analogue: when the page pool is exhausted (OutOfPagesError) a victim
request is *preempted*: its KV pages are copied to a host-side swap area,
its frames are freed, and it is re-mapped and restored later.  The cost is
measured in real bytes moved and reported in modeled AraOS cycles so the
§3.1 comparison is direct.

The pools are torch tensors ``[L, P, page, ...]`` (page axis 1).  Spill
gathers the victim's frames and copies them to host memory in the pool's
storage dtype (bf16 and int8 stay as they are: the record is a host torch
tensor, not numpy); restore writes them into freshly allocated frames in
place.  Byte and page counts are those of the JAX switcher.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.costmodel import CostModel
from repro_torch.core.vmem import VirtualMemory


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class SpilledState:
    """Swap-area record for one preempted request.

    ``page_data`` is host memory ``[2, L, n_pages, page, ...]`` (K then V)
    in the pool's storage dtype; nothing in it references the pool that
    spilled it."""

    seq_id: int
    num_tokens: int
    page_data: torch.Tensor          # host copy of the victim's pages
    extra_state: Any = None          # sampler state, resume cursor, ...
    bytes_moved: int = 0


@dataclasses.dataclass
class SwitchStats:
    """Accounting mirrored on the paper's measurements.

    ``bytes_spilled``/``bytes_restored`` count ONLY the victim sequence's
    pages — the page-granular contract the serving executor asserts against.
    """

    switches: int = 0
    bytes_spilled: int = 0
    bytes_restored: int = 0
    pages_spilled: int = 0
    pages_restored: int = 0
    modeled_cycles: float = 0.0

    def modeled_seconds(self, cost: CostModel) -> float:
        return cost.seconds(self.modeled_cycles)


class ContextSwitcher:
    """Spill/restore engine over stacked per-layer KV pools
    ``[L, num_phys_pages, page_size, ...]``.

    Spill copies the victim's pages out in logical order; restore writes
    them into freshly allocated frames — the physical pages may differ,
    exactly as after an OS swap-in.
    """

    def __init__(self, vmem: VirtualMemory, cost: CostModel | None = None):
        self.vmem = vmem
        self.cost = cost or CostModel()
        self.stats = SwitchStats()
        self._swap: dict[int, SpilledState] = {}

    def spill_kv(self, seq_id: int, k_pools: torch.Tensor,
                 v_pools: torch.Tensor, extra_state: Any = None) -> None:
        """Preempt ``seq_id`` by copying ONLY its pages out of both pools
        (``n_victim_pages * page_bytes * 2`` bytes, dtype-preserving)."""
        state = self.vmem.seq(seq_id)
        pages = torch.as_tensor(state.pages, dtype=torch.long,
                                device=k_pools.device)
        n = len(state.pages)
        page_data = torch.stack([k_pools.index_select(1, pages),
                                 v_pools.index_select(1, pages)]).cpu()
        nbytes = _nbytes(page_data)
        self._swap[seq_id] = SpilledState(
            seq_id=seq_id,
            num_tokens=state.length,
            page_data=page_data,
            extra_state=extra_state,
            bytes_moved=nbytes,
        )
        self.vmem.spill_seq(seq_id)
        self.stats.switches += 1
        self.stats.bytes_spilled += nbytes
        self.stats.pages_spilled += 2 * n
        self.stats.modeled_cycles += (
            self.cost.scalar_ctx_switch_cycles
            + self.cost.bytes_move_cycles(nbytes)
        )

    def restore_kv(self, seq_id: int, k_pools: torch.Tensor,
                   v_pools: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                   Any]:
        """Swap ``seq_id`` back in through a page-granular scatter into
        freshly allocated frames, in place.  Returns ``(k_pools, v_pools,
        extra_state)``.  Raises OutOfPagesError if frames are unavailable.

        Whole sequences only: the JAX switcher's shared-prefix re-share and
        partial restore come with the continuation slice."""
        spilled = self._swap[seq_id]
        state = self.vmem.restore_seq(seq_id, spilled.num_tokens)  # may raise
        pages = torch.as_tensor(state.pages, dtype=torch.long,
                                device=k_pools.device)
        k_pools.index_copy_(1, pages, spilled.page_data[0].to(k_pools.device))
        v_pools.index_copy_(1, pages, spilled.page_data[1].to(v_pools.device))
        del self._swap[seq_id]
        nbytes = _nbytes(spilled.page_data)
        self.stats.bytes_restored += nbytes
        self.stats.pages_restored += 2 * len(state.pages)
        self.stats.modeled_cycles += self.cost.bytes_move_cycles(nbytes)
        return k_pools, v_pools, spilled.extra_state

    def spilled_len(self, seq_id: int) -> int:
        """Token length recorded when ``seq_id`` was spilled — the only
        length a restore may legally re-map (KeyError if not spilled)."""
        return self._swap[seq_id].num_tokens

    def discard(self, seq_id: int) -> None:
        """Drop a swap record without restoring it (the request was failed
        by a scheduler reach check) — frees the host-side page copy."""
        self._swap.pop(seq_id, None)
