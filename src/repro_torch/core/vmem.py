"""Paged virtual tensor memory — the GPU restatement of AraOS's MMU.

AraOS gives the Ara2 vector unit virtual memory by letting its address
generator (ADDRGEN) translate virtual addresses through CVA6's MMU before each
AXI burst.  A CUDA kernel sees no user-visible MMU either, so the translation
layer is software: dynamically growing tensors (above all the serving KV
cache) live in *physical pages* of a preallocated device-memory pool, and a per-sequence *page table* maps logical token positions to physical
pages.

This module owns:
  * :class:`PagePool`      — the physical frame allocator ("the OS");
  * :class:`VirtualMemory` — per-sequence page tables, fault-driven growth,
    refcounted sharing (copy-on-write prefix reuse), spill/restore hooks;
  * device-side pure functions (`logical_to_physical`, `gather_pages`) used
    on device tensors;
  * address-trace extraction for the TLB simulator (`burst_trace`,
    `element_trace`) — these produce the *actual* page-access streams the
    kernels issue, which drive the paper's Fig.-2 reproduction.

Host-side state is NumPy (it is scheduler state, mutated between steps);
device-side functions take and return torch tensors on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.faults import OutOfPagesError, PageFault
from repro_torch.device import resolve_device

#: Sentinel for an unmapped page-table entry (like a cleared PTE valid bit).
INVALID_PAGE: int = -1


@dataclasses.dataclass(frozen=True)
class VMemConfig:
    """Geometry of the paged memory system.

    ``page_size`` is in *tokens*.  The default of 16 makes one page of one
    KV head 16 tokens x 128 head_dim x 2 B (bf16) = 4 KiB — the same burst
    granularity AXI enforces with 4-KiB pages.
    """

    page_size: int = 16
    num_pages: int = 1024
    max_pages_per_seq: int = 64
    max_seqs: int = 8

    def __post_init__(self) -> None:
        if self.page_size <= 0 or self.num_pages <= 0:
            raise ValueError("page_size and num_pages must be positive")
        if self.max_pages_per_seq <= 0 or self.max_seqs <= 0:
            raise ValueError("max_pages_per_seq and max_seqs must be positive")

    def pages_for(self, num_tokens: int) -> int:
        """Number of pages needed to back ``num_tokens`` tokens."""
        return -(-num_tokens // self.page_size)

    @property
    def max_tokens_per_seq(self) -> int:
        return self.max_pages_per_seq * self.page_size


class PagePool:
    """Physical frame allocator with refcounting.

    Refcounts support copy-on-write prefix sharing between requests (a
    beyond-paper feature mirroring vLLM's block sharing): a physical page may
    back the same logical prefix of several sequences; it is returned to the
    free list only when the last reference drops.
    """

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._refcount = np.zeros(self.num_pages, dtype=np.int32)
        # LIFO free list: reuse hot frames first (cache friendliness).
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        self.alloc_count = 0
        self.fault_count = 0

    # ---- queries ------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refcount[page])

    # ---- allocation ----------------------------------------------------

    def alloc(self, n: int = 1) -> list[int]:
        """Allocate ``n`` physical pages or raise :class:`OutOfPagesError`."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise OutOfPagesError(requested=n, available=len(self._free))
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self._refcount[p] == 0, f"free page {p} had refcount"
            self._refcount[p] = 1
        self.alloc_count += n
        return pages

    def share(self, page: int) -> int:
        """Add a reference to ``page`` (copy-on-write sharing)."""
        if self._refcount[page] <= 0:
            raise ValueError(f"cannot share unallocated page {page}")
        self._refcount[page] += 1
        return page

    def free(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; return pages that reach zero."""
        for p in pages:
            if p == INVALID_PAGE:
                continue
            if self._refcount[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(int(p))

    def check_invariants(self) -> None:
        """Allocator invariants (property-tested)."""
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "free list has duplicates"
        for p in self._free:
            assert self._refcount[p] == 0, f"free page {p} has refcount"
        assert int((self._refcount > 0).sum()) == self.num_used


@dataclasses.dataclass
class SeqState:
    """Host-side bookkeeping for one mapped sequence."""

    seq_id: int
    slot: int                     # row in the batch page table
    length: int                   # tokens currently mapped
    pages: list[int]              # physical pages, logical order


class VirtualMemory:
    """Per-sequence page tables over a shared :class:`PagePool`.

    This is the "OS" of the serving engine: it owns the satp-equivalent (the
    batch page-table array handed to kernels), handles page faults by
    allocating frames on demand, and exposes spill/restore for context
    switches.
    """

    def __init__(self, config: VMemConfig):
        self.config = config
        self.pool = PagePool(config.num_pages)
        self._seqs: dict[int, SeqState] = {}
        self._free_slots: list[int] = list(range(config.max_seqs - 1, -1, -1))
        # NumPy mirror of the device page table.
        self._table = np.full(
            (config.max_seqs, config.max_pages_per_seq), INVALID_PAGE, np.int32
        )
        self._lens = np.zeros(config.max_seqs, dtype=np.int32)
        # rows whose PTEs changed since the last ``drain_dirty_rows`` — the
        # device-resident copy of the table (serve.Executor) is updated
        # incrementally from these deltas instead of re-uploaded wholesale.
        self._dirty_rows: set[int] = set()
        # observers of mapping teardown (unmap_seq / spill_seq): the serve
        # prefix cache keys its radix index off these so it never
        # advertises pages whose frames have been freed.
        self._unmap_hooks: list = []

    # ---- queries ------------------------------------------------------

    @property
    def num_seqs(self) -> int:
        return len(self._seqs)

    def seq(self, seq_id: int) -> SeqState:
        return self._seqs[seq_id]

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self._seqs

    def seq_len(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    @property
    def num_free_slots(self) -> int:
        return len(self._free_slots)

    def add_unmap_hook(self, fn) -> None:
        """Register ``fn(seq_id)`` to fire whenever a sequence's mapping is
        torn down — retirement (:meth:`unmap_seq`), preemption
        (:meth:`spill_seq`), or a fork rollback.  The serve-plane prefix
        cache uses this to evict its index entries the moment the page run
        they describe stops being resident (refcounts may drop to zero)."""
        self._unmap_hooks.append(fn)

    def device_page_table(self, device=None) -> torch.Tensor:
        """The satp analogue: `[max_seqs, max_pages_per_seq] int32`."""
        return torch.as_tensor(self._table.copy(), device=resolve_device(device))

    def device_seq_lens(self, device=None) -> torch.Tensor:
        return torch.as_tensor(self._lens.copy(), device=resolve_device(device))

    def drain_dirty_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """Rows of the page table mutated since the last drain.

        Returns ``(row_indices [D] int32, row_contents [D, max_pages] int32)``
        and clears the dirty set.  The serving executor applies these as a
        scatter into its persistent device-side table — the decode hot path
        never re-uploads the whole satp array.
        """
        rows = np.asarray(sorted(self._dirty_rows), np.int32)
        self._dirty_rows.clear()
        return rows, self._table[rows].copy()

    # ---- mapping ------------------------------------------------------

    def map_seq(self, seq_id: int, num_tokens: int) -> SeqState:
        """Map a new sequence with ``num_tokens`` tokens (prefill).

        Raises :class:`OutOfPagesError` if the pool cannot back it — callers
        (the scheduler) respond by preempting a victim (context switch).
        """
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already mapped")
        if num_tokens > self.config.max_tokens_per_seq:
            raise ValueError(
                f"seq of {num_tokens} tokens exceeds page-table reach "
                f"{self.config.max_tokens_per_seq}"
            )
        if not self._free_slots:
            raise OutOfPagesError(requested=1, available=0, kind="slots")
        n_pages = self.config.pages_for(num_tokens)
        pages = self.pool.alloc(n_pages)  # may raise OutOfPagesError
        slot = self._free_slots.pop()
        state = SeqState(seq_id=seq_id, slot=slot, length=num_tokens, pages=pages)
        self._seqs[seq_id] = state
        self._table[slot, :n_pages] = pages
        self._lens[slot] = num_tokens
        self._dirty_rows.add(slot)
        return state

    def fork_seq(self, parent_id: int, child_id: int, prefix_tokens: int) -> SeqState:
        """Map ``child_id`` sharing the parent's full-page prefix (COW).

        Only whole pages are shared; a partially filled tail page is copied
        by the caller (it owns the data arrays).
        """
        parent = self._seqs[parent_id]
        if prefix_tokens > parent.length:
            raise ValueError("prefix longer than parent")
        if not self._free_slots:
            raise OutOfPagesError(requested=1, available=0, kind="slots")
        whole = prefix_tokens // self.config.page_size
        shared = [self.pool.share(p) for p in parent.pages[:whole]]
        tail = self.config.pages_for(prefix_tokens) - whole
        try:
            own = self.pool.alloc(tail)
        except OutOfPagesError:
            self.pool.free(shared)
            raise
        pages = shared + own
        slot = self._free_slots.pop()
        state = SeqState(seq_id=child_id, slot=slot, length=prefix_tokens, pages=pages)
        self._seqs[child_id] = state
        self._table[slot, : len(pages)] = pages
        self._lens[slot] = prefix_tokens
        self._dirty_rows.add(slot)
        return state

    def append_tokens(self, seq_id: int, n: int = 1) -> list[PageFault]:
        """Extend a sequence by ``n`` tokens, faulting in new pages.

        Returns the list of page faults taken (empty if the tail page had
        room).  Each fault allocates a frame on demand — the vstart-style
        *element index* of the fault is recorded so benchmarks can model the
        paper's mid-instruction fault cost.  Raises OutOfPagesError if the
        pool is exhausted; the sequence is left unmodified in that case
        (precise-exception semantics: architectural state is only committed
        once all translations succeed).
        """
        state = self._seqs[seq_id]
        new_len = state.length + n
        if new_len > self.config.max_tokens_per_seq:
            raise ValueError("sequence exceeds page-table reach")
        need = self.config.pages_for(new_len) - len(state.pages)
        faults: list[PageFault] = []
        if need > 0:
            first_new_page = len(state.pages)
            pages = self.pool.alloc(need)  # may raise; state untouched
            self.pool.fault_count += need
            self._dirty_rows.add(state.slot)
            for i, p in enumerate(pages):
                lpn = first_new_page + i
                self._table[state.slot, lpn] = p
                faults.append(
                    PageFault(
                        seq_id=seq_id,
                        logical_page=lpn,
                        vstart=lpn * self.config.page_size - state.length,
                    )
                )
            state.pages.extend(pages)
        state.length = new_len
        self._lens[state.slot] = new_len
        return faults

    def append_tokens_batch(
        self, grows: Sequence[tuple[int, int]]
    ) -> list[PageFault]:
        """All-or-nothing growth of several sequences at once.

        The serving scheduler pre-faults every page a fused K-step decode
        horizon will touch through ONE call, so the device page table is
        flushed once per horizon (``drain_dirty_rows``) instead of once per
        token.  ``grows`` is ``[(seq_id, n_tokens), ...]``.  If the pool
        cannot back the ENTIRE batch, :class:`OutOfPagesError` is raised
        with no sequence modified (precise-exception semantics, batch-wide)
        — callers collapse the horizon to K=1 and fall back to the
        per-step fault path, which may preempt.
        """
        need = 0
        for seq_id, n in grows:
            state = self._seqs[seq_id]
            new_len = state.length + n
            if new_len > self.config.max_tokens_per_seq:
                raise ValueError("sequence exceeds page-table reach")
            need += max(0, self.config.pages_for(new_len) - len(state.pages))
        if need > self.pool.num_free:
            raise OutOfPagesError(requested=need, available=self.pool.num_free)
        faults: list[PageFault] = []
        for seq_id, n in grows:
            if n > 0:
                faults.extend(self.append_tokens(seq_id, n))
        return faults

    def unmap_seq(self, seq_id: int) -> None:
        state = self._seqs.pop(seq_id)
        self.pool.free(state.pages)
        self._table[state.slot, :] = INVALID_PAGE
        self._lens[state.slot] = 0
        self._free_slots.append(state.slot)
        self._dirty_rows.add(state.slot)
        for fn in self._unmap_hooks:
            fn(seq_id)

    # ---- spill / restore (context switch) --------------------------------

    def spill_seq(self, seq_id: int) -> SeqState:
        """Release a sequence's frames for preemption, returning its state.

        The caller (context_switch.py) is responsible for copying the page
        *data* out before calling this; VirtualMemory only manages mappings.
        """
        state = self._seqs.pop(seq_id)
        self.pool.free(state.pages)
        self._table[state.slot, :] = INVALID_PAGE
        self._lens[state.slot] = 0
        self._free_slots.append(state.slot)
        self._dirty_rows.add(state.slot)
        for fn in self._unmap_hooks:
            fn(seq_id)
        return state

    def restore_seq(self, seq_id: int, num_tokens: int,
                    shared_prefix_pages: Sequence[int] | None = None
                    ) -> SeqState:
        """Re-map a previously spilled sequence (frames may differ).

        ``shared_prefix_pages``: physical frames, still resident under
        another mapping (in practice the pinned engine prefix), to re-SHARE
        as the sequence's leading pages by refcount instead of demanding
        fresh frames.  The caller guarantees their content already equals
        the corresponding spilled bytes (whole shared pages are immutable
        while refcounted), so only the unshared tail needs frames — the
        reason a victim whose footprint exceeds the preemptible pool can
        still be restorable.

        ``num_tokens`` may be any page-aligned-or-shorter prefix of the
        spilled length (a PARTIAL restore): the scheduler re-maps the
        longest prefix that fits now and re-prefills the evicted tail
        through the continuation path, so this layer only ever sees a
        smaller ``num_tokens`` — no partial-mapping state exists here.
        """
        if not shared_prefix_pages:
            return self.map_seq(seq_id, num_tokens)
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already mapped")
        if num_tokens > self.config.max_tokens_per_seq:
            raise ValueError(
                f"seq of {num_tokens} tokens exceeds page-table reach "
                f"{self.config.max_tokens_per_seq}"
            )
        if not self._free_slots:
            raise OutOfPagesError(requested=1, available=0, kind="slots")
        n_pages = self.config.pages_for(num_tokens)
        if len(shared_prefix_pages) > n_pages:
            raise ValueError("more shared pages than the sequence spans")
        shared = [self.pool.share(p) for p in shared_prefix_pages]
        try:
            own = self.pool.alloc(n_pages - len(shared))
        except OutOfPagesError:
            self.pool.free(shared)
            raise
        pages = shared + own
        slot = self._free_slots.pop()
        state = SeqState(seq_id=seq_id, slot=slot, length=num_tokens,
                         pages=pages)
        self._seqs[seq_id] = state
        self._table[slot, :n_pages] = pages
        self._lens[slot] = num_tokens
        self._dirty_rows.add(slot)
        return state

    # ---- translation (host-side, trace-producing) -------------------------

    def translate(self, seq_id: int, positions: np.ndarray) -> np.ndarray:
        """Translate token positions to flat physical slot indices.

        Raises :class:`PageFault` (as an exception) on an unmapped position,
        carrying the vstart-equivalent index of the first faulting element —
        mirroring Ara2 stopping the ADDRGEN at the faulty element.
        """
        state = self._seqs[seq_id]
        positions = np.asarray(positions)
        bad = positions >= state.length
        if bad.any():
            first = int(np.argmax(bad))
            raise PageFault(
                seq_id=seq_id,
                logical_page=int(positions[first]) // self.config.page_size,
                vstart=first,
            )
        vpn = positions // self.config.page_size
        off = positions % self.config.page_size
        ppn = self._table[state.slot, vpn]
        return ppn * self.config.page_size + off

    def check_invariants(self) -> None:
        self.pool.check_invariants()
        seen: set[int] = set()
        for s in self._seqs.values():
            assert len(s.pages) == self.config.pages_for(s.length)
            for p in s.pages:
                assert self.pool.refcount(p) >= 1
            mapped = self._table[s.slot, : len(s.pages)]
            assert (mapped == np.asarray(s.pages, np.int32)).all()
            assert s.slot not in seen
            seen.add(s.slot)


# ===========================================================================
# Device-side functions (torch tensors)
# ===========================================================================


def logical_to_physical(
    positions: torch.Tensor, page_table_row: torch.Tensor, page_size: int
) -> torch.Tensor:
    """Translate logical token positions to flat physical slots (on device).

    ``positions``: int32 [...] token positions of one sequence.
    ``page_table_row``: int32 [max_pages_per_seq] physical page numbers.
    Returns int32 [...] of ``ppn * page_size + offset``.
    """
    vpn = positions // page_size
    off = positions % page_size
    ppn = page_table_row[vpn.long()]
    return ppn * page_size + off


def gather_pages(
    kv_pool: torch.Tensor, page_table_row: torch.Tensor, num_pages: int
) -> torch.Tensor:
    """Gather ``num_pages`` physical pages into logical order.

    ``kv_pool``: [num_phys_pages, page_size, ...] physical storage.
    Returns [num_pages, page_size, ...] in logical page order.
    """
    return kv_pool.index_select(0, page_table_row[:num_pages].long())


# ===========================================================================
# Address-trace extraction (feeds the TLB simulator)
# ===========================================================================


def burst_trace(positions: Sequence[int] | np.ndarray, page_size: int) -> np.ndarray:
    """VPN trace for a *unit-stride* access: one translation per page burst.

    AXI bursts are clipped at page boundaries, so a contiguous vector access
    of N tokens issues one MMU request per page touched, in order (paper C2).
    """
    positions = np.asarray(positions)
    vpn = positions // page_size
    # collapse consecutive repeats: one burst per page-run
    if vpn.size == 0:
        return vpn.astype(np.int64)
    keep = np.ones(vpn.shape, dtype=bool)
    keep[1:] = vpn[1:] != vpn[:-1]
    return vpn[keep].astype(np.int64)


def element_trace(positions: Sequence[int] | np.ndarray, page_size: int) -> np.ndarray:
    """VPN trace for an *indexed* access: one translation per element.

    AraOS pays a dedicated translation per element on indexed memory ops to
    keep exceptions precise — the reason spmv/canneal underperform (paper
    §3.2).  No run-collapsing here.
    """
    positions = np.asarray(positions)
    return (positions // page_size).astype(np.int64)
