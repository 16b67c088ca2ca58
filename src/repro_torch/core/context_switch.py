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
place — whole, after a shared pinned prefix, or only a leading part
(partial restore).  Byte and page counts are those of the JAX switcher.

On a ('kv', 'hd') serve mesh the pools are DTensors, each rank holding its
(kv, hd) slice.  Spill selects the victim's frames from this rank's slice
and gathers the slices of every rank in one collective, so every rank
keeps the WHOLE record, byte for byte the record one device would have
spilled (as JAX's host record is the whole array): the stats, and the
portability of records between a mesh engine and a one-device engine,
are unchanged.  Restore writes this rank's slice of the record into its
local pools, in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.costmodel import CostModel
from repro_torch.core.vmem import VirtualMemory
from repro_torch.kernels import ops


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record_layout(pools):
    """The layout of a record ``[2, L, n, page, Hkv, hd]`` of DTensor
    ``pools``: theirs, one dim further on."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                 for p in pools.placements)


def _spill_pages(k_pools, v_pools, pages: list[int]) -> torch.Tensor:
    """``[2, L, n, page, ...]`` host copy of both pools' frames ``pages``;
    on a mesh this rank's slice of them, then the slices of every rank
    gathered whole in one collective."""
    if not ops.is_dtensor(k_pools):
        idx = torch.as_tensor(pages, dtype=torch.long, device=k_pools.device)
        return torch.stack([k_pools.index_select(1, idx),
                            v_pools.index_select(1, idx)]).cpu()
    kl, vl = k_pools.to_local(), v_pools.to_local()
    idx = torch.as_tensor(pages, dtype=torch.long, device=kl.device)
    local = torch.stack([kl.index_select(1, idx), vl.index_select(1, idx)])
    return ops.gather_whole(local, k_pools.device_mesh,
                            _record_layout(k_pools)).cpu()


def _restore_pages(k_pools, v_pools, pages: list[int],
                   data: torch.Tensor) -> None:
    """Write record ``data`` ``[2, L, n, page, ...]`` into both pools'
    frames ``pages``, in place; on a mesh, this rank's slice of it into
    the local pools."""
    if ops.is_dtensor(k_pools):
        data = ops.local_slice(data, k_pools.device_mesh,
                               _record_layout(k_pools))
        k_pools, v_pools = k_pools.to_local(), v_pools.to_local()
    idx = torch.as_tensor(pages, dtype=torch.long, device=k_pools.device)
    k_pools.index_copy_(1, idx, data[0].to(k_pools.device))
    v_pools.index_copy_(1, idx, data[1].to(v_pools.device))


@dataclasses.dataclass
class SpilledState:
    """Swap-area record for one preempted request.

    ``page_data`` is host memory ``[2, L, n_pages, page, ...]`` (K then V;
    from the whole-pool :meth:`ContextSwitcher.spill`, the pool's shape
    with ``n_pages`` along its page axis) in the pool's storage dtype;
    nothing in it references the pool that
    spilled it.  The record is therefore **portable**: one replica's
    switcher can export it (:meth:`ContextSwitcher.export_swap`) and
    another's import it (:meth:`ContextSwitcher.import_swap`) and restore
    it into its own pools, provided both share the page geometry — the
    cross-replica migration of a starved swap victim."""

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
    exactly as after an OS swap-in.  The whole-pool API (:meth:`spill`,
    :meth:`can_restore`, :meth:`restore`) takes ONE pool with its frames
    along ``page_axis``; only the frozen seed engine
    (:mod:`repro_torch.serve.reference`) calls it.
    """

    def __init__(self, vmem: VirtualMemory, cost: CostModel | None = None,
                 page_axis: int = 0):
        self.vmem = vmem
        self.cost = cost or CostModel()
        self.stats = SwitchStats()
        self._swap: dict[int, SpilledState] = {}
        #: which axis of a WHOLE pool indexes physical frames — read only by
        #: the whole-pool API (:meth:`spill` / :meth:`restore`; the seed
        #: engine's flat ``[2L, P, page, ...]`` pool uses 1)
        self.page_axis = page_axis

    def spill_kv(self, seq_id: int, k_pools: torch.Tensor,
                 v_pools: torch.Tensor, extra_state: Any = None) -> None:
        """Preempt ``seq_id`` by copying ONLY its pages out of both pools
        (``n_victim_pages * page_bytes * 2`` bytes, dtype-preserving)."""
        state = self.vmem.seq(seq_id)
        n = len(state.pages)
        page_data = _spill_pages(k_pools, v_pools, state.pages)
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
                   v_pools: torch.Tensor,
                   shared_prefix_pages: list[int] | None = None,
                   num_tokens: int | None = None,
                   ) -> tuple[torch.Tensor, torch.Tensor, Any]:
        """Swap ``seq_id`` back in through a page-granular scatter into
        freshly allocated frames, in place.  Returns ``(k_pools, v_pools,
        extra_state)``.  Raises OutOfPagesError if frames are unavailable.

        ``shared_prefix_pages``: leading frames to re-share by refcount
        (``VirtualMemory.restore_seq``) instead of re-mapping — they are
        still resident (the pinned prefix) and hold bytes identical to the
        spilled copy, so they are neither allocated nor written; only the
        unshared tail moves, and only it is counted in
        ``bytes_restored``/``pages_restored``.

        ``num_tokens``: PARTIAL restore — re-map and write only the leading
        ``num_tokens`` of the record (which must cover the shared frames);
        the record's evicted tail pages are dropped and the caller
        re-prefills those positions through the continuation path.  Either
        way the swap record is consumed."""
        spilled = self._swap[seq_id]
        keep = spilled.num_tokens if num_tokens is None else int(num_tokens)
        if not 0 < keep <= spilled.num_tokens:
            raise ValueError(
                f"partial restore of seq {seq_id}: num_tokens={keep} "
                f"outside (0, {spilled.num_tokens}]")
        state = self.vmem.restore_seq(
            seq_id, keep, shared_prefix_pages)  # may raise
        skip = len(shared_prefix_pages or ())
        n_keep = len(state.pages)
        data = spilled.page_data[:, :, skip:n_keep]
        if n_keep > skip:
            _restore_pages(k_pools, v_pools, state.pages[skip:], data)
        del self._swap[seq_id]
        nbytes = _nbytes(data)
        self.stats.bytes_restored += nbytes
        self.stats.pages_restored += 2 * (n_keep - skip)
        self.stats.modeled_cycles += self.cost.bytes_move_cycles(nbytes)
        return k_pools, v_pools, spilled.extra_state

    def export_swap(self, seq_id: int) -> SpilledState:
        """Detach ``seq_id``'s swap record for migration to ANOTHER
        replica's switcher.  Its frames were freed at spill time and the
        record is host memory, so after the pop nothing here references
        the victim.  KeyError if not spilled."""
        return self._swap.pop(seq_id)

    def import_swap(self, record: SpilledState) -> None:
        """Adopt a swap record exported from another replica's switcher.

        Both checks raise before anything moves: the page count the record
        carries (``page_data.shape[2]``) must be what a restore here would
        re-map for its ``num_tokens``, and the sequence must not be spilled
        here already.  Nothing is copied to the device until the restore,
        which writes into this replica's pools in place."""
        need = self.vmem.config.pages_for(record.num_tokens)
        have = int(record.page_data.shape[2])
        if have != need:
            raise ValueError(
                f"import_swap of seq {record.seq_id}: record carries "
                f"{have} pages but {record.num_tokens} tokens need {need} "
                f"under page_size={self.vmem.config.page_size}")
        if record.seq_id in self._swap:
            raise ValueError(
                f"import_swap: seq {record.seq_id} already spilled here")
        self._swap[record.seq_id] = record

    # ---- whole-pool legacy API, kept for the seed engine ------------------

    def spill(self, seq_id: int, pool: torch.Tensor,
              extra_state: Any = None) -> torch.Tensor:
        """Preempt ``seq_id``: copy its frames out of ``pool`` along
        ``page_axis`` to a host tensor (the pool's dtype), free them.
        Returns the pool unchanged (data in freed frames is dead).  As in
        JAX, ``pages_spilled`` is not counted here."""
        state = self.vmem.seq(seq_id)
        idx = torch.as_tensor(state.pages, dtype=torch.long,
                              device=pool.device)
        page_data = pool.index_select(self.page_axis, idx).cpu()
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
        self.stats.modeled_cycles += (
            self.cost.scalar_ctx_switch_cycles
            + self.cost.bytes_move_cycles(nbytes)
        )
        return pool

    def can_restore(self, seq_id: int) -> bool:
        """Whether a whole restore of ``seq_id`` fits now: its frames are
        free and so is a slot."""
        if seq_id not in self._swap:
            return False
        need = self.vmem.config.pages_for(self._swap[seq_id].num_tokens)
        return self.vmem.pool.num_free >= need and self.vmem.num_free_slots > 0

    def restore(self, seq_id: int, pool: torch.Tensor
                ) -> tuple[torch.Tensor, Any]:
        """Swap ``seq_id`` back in: new frames, its record written into
        them along ``page_axis`` (0 or 1), in place.  Returns ``(pool,
        extra_state)``.  Raises ``OutOfPagesError`` (frames unavailable)
        or ``NotImplementedError`` (another axis) before anything moves;
        ``pages_restored`` is not counted, as in JAX."""
        spilled = self._swap[seq_id]
        if self.page_axis not in (0, 1):
            raise NotImplementedError(f"page_axis={self.page_axis}")
        state = self.vmem.restore_seq(seq_id, spilled.num_tokens)  # may raise
        idx = torch.as_tensor(state.pages, dtype=torch.long,
                              device=pool.device)
        pool.index_copy_(self.page_axis, idx,
                         spilled.page_data.to(pool.device))
        del self._swap[seq_id]
        nbytes = _nbytes(spilled.page_data)
        self.stats.bytes_restored += nbytes
        self.stats.modeled_cycles += self.cost.bytes_move_cycles(nbytes)
        return pool, spilled.extra_state

    def spilled_len(self, seq_id: int) -> int:
        """Token length recorded when ``seq_id`` was spilled — the only
        length a restore may legally re-map (KeyError if not spilled)."""
        return self._swap[seq_id].num_tokens

    @property
    def swapped_out(self) -> list[int]:
        """Ids of the sequences whose swap records are held."""
        return sorted(self._swap)

    def discard(self, seq_id: int) -> None:
        """Drop a swap record without restoring it (the request was failed
        by a scheduler reach check) — frees the host-side page copy."""
        self._swap.pop(seq_id, None)
