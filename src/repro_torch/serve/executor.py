"""Device-resident serving executor — the Ara2 data plane of the split.

Port of ``src/repro/serve/executor.py`` for one card.  Everything that
touches a device tensor lives here: the paged KV pools, a *persistent
device page table* (the satp analogue, updated incrementally from
``VirtualMemory.drain_dirty_rows()`` deltas — never re-uploaded
wholesale), and the prefill / decode steps, which update the KV pools in
place.

  * page-table updates are delta-only (``ptab_rows_uploaded`` counter);
  * spill/restore move only the victim sequence's pages
    (``ContextSwitcher.spill_kv``/``restore_kv``);
  * inactive decode lanes are masked on the device from a [B] bool mask,
    not by rewriting table rows on the host;
  * decode runs in fused K-step horizons (``decode_multi``): a Python loop
    of K ``decode_step``s with on-device sampling and per-lane retire
    masking, then ONE host transfer of the ``[K, B]`` token block, so the
    host round-trip and the page-table delta sync are paid once per
    horizon (``host_syncs`` / ``decode_horizon`` counters);
  * forked admissions (``share_prefix`` forks of the preloaded prefix,
    radix-cache hits, the re-prefilled tail of a partial restore) run as
    ONE batched continuation prefill per step (``admit_forked_batch``):
    copy-on-write tail pages in one indexed assignment, then
    ``TransformerLM.prefill_continue`` with a per-row start offset;
  * restore re-shares pinned-prefix frames by refcount and may re-map
    only a leading part of the record (partial restore);
  * every compute step is tallied as ``kernel_dispatches`` (the kernel
    wrappers) or ``ref_path_dispatches`` (the explicit plain-version hatch,
    ``ServeConfig.use_ref_path``).

Not ported yet: swap-record migration (``export_swap``/``import_swap``)
comes with the router slice; AOT buckets and the serve mesh are refused
by the engine.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from repro_torch.core import (
    ContextSwitcher,
    CostModel,
    INVALID_PAGE,
    PerfCounters,
    VirtualMemory,
)
from repro_torch.kernels import ops
from repro_torch.kernels.paged_prefill_attention import (
    pages_touched,
    prefill_route_rule,
    query_block,
)
from repro_torch.models.transformer import PagedKVState, TransformerLM, sample
from repro_torch.serve.scheduler import DecodePlan, Request, ServeConfig

_ROUTER = ("is not ported yet: it comes with the router slice of the "
           "PyTorch port")


def _twin(model: TransformerLM, **attrs) -> TransformerLM:
    """A shallow copy of ``model`` with ``attrs`` rebound (kv-dtype or
    plain-path twin); parameters are shared, not copied."""
    twin = copy.copy(model)
    for k, v in attrs.items():
        setattr(twin, k, v)
    return twin


class Executor:
    """Owns KV pools + the device page table; executes scheduler plans."""

    def __init__(self, model: TransformerLM, params: Any, cfg: ServeConfig,
                 vmem: VirtualMemory, cost: CostModel | None = None,
                 counters: PerfCounters | None = None):
        if cfg.kv_dtype != model.kv_dtype:
            # quantized-pool twin FIRST: the pools below allocate its dtype
            model = _twin(model, kv_dtype=cfg.kv_dtype)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.vmem = vmem
        self.device = model.device
        self.counters = counters or PerfCounters()
        self.switcher = ContextSwitcher(vmem, cost)
        # the device pool has num_pages frames; the allocator saw one less
        # (last frame = scratch for masked lanes)
        self.kv = model.init_kv_state(
            cfg.max_batch, cfg.num_pages, cfg.page_size, cfg.max_pages_per_seq
        )
        #: persistent satp: updated by delta scatter, read by every step
        self._ptab = torch.full(
            (cfg.max_batch, cfg.max_pages_per_seq), INVALID_PAGE,
            dtype=torch.int32, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._step_model = model
        #: True iff compute steps run the plain versions on purpose
        self._ref_path = bool(cfg.use_ref_path)
        if self._ref_path:
            self._step_model = _twin(model, use_kernels=False)

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _block(self) -> None:
        """Wait for the device so the step timers measure execution."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # persistent device page table
    # ------------------------------------------------------------------

    def sync_page_table(self) -> None:
        """Apply host page-table deltas (dirty rows only) to the device."""
        rows, vals = self.vmem.drain_dirty_rows()
        if rows.size:
            self._ptab[self._tensor(rows, torch.long)] = self._tensor(vals)
            self.counters.inc("ptab_rows_uploaded", int(rows.size))
            self.counters.inc("ptab_syncs")

    # ------------------------------------------------------------------
    # compute steps
    # ------------------------------------------------------------------

    def _count_dispatch(self) -> None:
        """Kernel-vs-plain observability, once per compute step."""
        if self._ref_path:
            self.counters.inc("ref_path_dispatches")
        else:
            self.counters.inc("kernel_dispatches")
        if self._step_model.kv_dtype != "native":
            self.counters.inc("quant_dispatches")

    def _state(self, page_table, seq_lens) -> PagedKVState:
        return PagedKVState(self.kv.k_pools, self.kv.v_pools, page_table,
                            seq_lens)

    def _pad_prompt_batch(self, reqs: list[Request]):
        """Burst-aligned ``[B, smax]`` prompt matrix + true lengths + the
        batch's page-table rows — shared by cold and forked admission, so
        padding and slot lookup cannot drift between them."""
        page = self.cfg.page_size
        smax = max(len(r.prompt) for r in reqs)
        smax = -(-smax // page) * page            # burst-align
        tokens = np.zeros((len(reqs), smax), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : len(r.prompt)] = r.prompt
        lens = np.asarray([len(r.prompt) for r in reqs], np.int32)
        slots = [self.vmem.seq(r.req_id).slot for r in reqs]
        pt_rows = self._ptab.index_select(0, self._tensor(slots, torch.long))
        return self._tensor(tokens), self._tensor(lens), pt_rows

    def prefill(self, reqs: list[Request]) -> list[np.ndarray]:
        """Batched prefill of freshly admitted requests; returns the first
        sampled token per request (request order)."""
        self.sync_page_table()
        tokens, lens, pt_rows = self._pad_prompt_batch(reqs)
        with self.counters.timer("prefill"):
            logits, _ = self._step_model.prefill(
                self.params, tokens, lens,
                self._state(pt_rows, torch.zeros_like(lens)))
            self._block()
        self._count_dispatch()
        first = self.sample(logits)
        return [np.asarray(first[i]) for i in range(len(reqs))]

    def decode(self, tokens: np.ndarray, pre_lens: np.ndarray,
               active: np.ndarray) -> np.ndarray:
        """One full-slot decode step (the horizon's K=1 collapse path);
        returns sampled tokens by slot."""
        self.sync_page_table()
        with self.counters.timer("decode"):
            # mask rows of slots NOT decoding this step: their KV write
            # must land in the scratch row, never in a live frame
            act = self._tensor(active, torch.bool)
            masked = torch.where(act[:, None], self._ptab, INVALID_PAGE)
            logits, _ = self._step_model.decode_step(
                self.params, self._tensor(tokens),
                self._state(masked, self._tensor(pre_lens)))
            self._block()
        self._count_dispatch()
        self.counters.inc("decode_dispatches")
        self.counters.inc("decode_horizon")
        return self.sample(logits)

    def decode_multi(self, plan: DecodePlan) -> np.ndarray:
        """Fused K-step decode horizon: ``plan.horizon`` chained decode
        steps with on-device sampling and per-lane retire masking, then the
        whole ``[K, B]`` token block in one host transfer."""
        self.sync_page_table()
        with self.counters.timer("decode"):
            block, _ = self._step_model.decode_multi_step(
                self.params, self._tensor(plan.tokens),
                self._state(self._ptab, self._tensor(plan.pre_lens)),
                self._tensor(plan.steps_left), self._gen,
                float(self.cfg.temperature), horizon=plan.horizon,
                greedy=self.cfg.greedy,
            )
            out = block.to(torch.int32).cpu().numpy()   # the one host sync
        self._count_dispatch()
        self.counters.inc("host_syncs")
        self.counters.inc("decode_dispatches")
        self.counters.inc("decode_horizon", plan.horizon)
        return out

    # ------------------------------------------------------------------
    # DataPlane protocol (driven by the Scheduler)
    # ------------------------------------------------------------------

    def _continuation_gather_bytes(self, start_lens, smax: int,
                                   nrows: int) -> int:
        """K+V bytes the continuation attention reads per layer stack, by
        the route that ran: a kernel fetches ``pages_touched`` pages per
        row with its route's query block (the serve path's views are
        aligned, so the route follows from dtypes and shapes), the plain
        version gathers every row's full table reach."""
        cfg = self.model.cfg
        per_tok = (2 * cfg.num_kv_heads * cfg.head_dim
                   * self.kv.k_pools.element_size())
        if ops.kernel_route(self.kv.k_pools, self._step_model.use_kernels):
            route = prefill_route_rule(
                self._step_model.dtype, self.kv.k_pools.dtype,
                cfg.q_per_kv, cfg.head_dim, self.cfg.page_size)
            bq = query_block(cfg.q_per_kv, route)
            pages = sum(pages_touched(st, smax, self.cfg.max_pages_per_seq,
                                      page_size=self.cfg.page_size, bq=bq)
                        for st in start_lens)
            tokens = pages * self.cfg.page_size
        else:
            tokens = nrows * self.cfg.max_pages_per_seq * self.cfg.page_size
        return cfg.num_layers * per_tok * tokens

    def _copy_pages(self, copies: list[tuple[int, int]]) -> None:
        """Copy-on-write tail pages: every forked frame of both pools in one
        indexed assignment each."""
        srcs = self._tensor([src for src, _ in copies], torch.long)
        dsts = self._tensor([dst for _, dst in copies], torch.long)
        self.kv.k_pools[:, dsts] = self.kv.k_pools[:, srcs]
        self.kv.v_pools[:, dsts] = self.kv.v_pools[:, srcs]

    def admit_forked_batch(self, reqs: list[Request], start_lens: list[int],
                           tail_copies: list[tuple[int, int] | None]
                           ) -> list[np.ndarray]:
        """COW tail copies + ONE batched continuation prefill for all
        same-step forked admissions (each request's chunk starts at its own
        logical offset); returns the first sampled token per request."""
        self.sync_page_table()
        copies = [tc for tc in tail_copies if tc is not None]
        if copies:
            self._copy_pages(copies)
        chunks, lens, pt_rows = self._pad_prompt_batch(reqs)
        starts = self._tensor(start_lens)
        with self.counters.timer("prefill"):
            logits, _ = self._step_model.prefill_continue(
                self.params, chunks, starts, lens,
                self._state(pt_rows, starts))
            self._block()
        self._count_dispatch()
        self.counters.inc("continuation_prefill_tokens", int(lens.sum()))
        self.counters.inc("prefill_bytes_gathered",
                          self._continuation_gather_bytes(
                              [int(s) for s in start_lens],
                              int(chunks.shape[1]), len(reqs)))
        first = self.sample(logits)
        return [np.asarray(first[i]) for i in range(len(reqs))]

    def preload_prefix(self, prefix_tokens, slot: int, n: int) -> None:
        """Prefill the resident shared prefix into the frames mapped for
        ``slot`` (one cold prefill of the burst-aligned prefix)."""
        self.sync_page_table()
        page = self.cfg.page_size
        tokens = np.zeros((1, -(-n // page) * page), np.int32)
        tokens[0, :n] = np.asarray(prefix_tokens, np.int32)
        pt_rows = self._ptab.index_select(0, self._tensor([slot], torch.long))
        lens = self._tensor([n])
        self._step_model.prefill(self.params, self._tensor(tokens), lens,
                                 self._state(pt_rows, torch.zeros_like(lens)))
        self._count_dispatch()
        self.counters.inc("prefix_tokens", n)

    def spill(self, req: Request) -> None:
        """Page-granular spill: only the victim's frames leave the device."""
        self.switcher.spill_kv(req.req_id, self.kv.k_pools, self.kv.v_pools)

    def restore(self, req: Request, num_tokens: int,
                shared_pages: list[int] | None = None) -> None:
        """Page-granular restore into freshly allocated frames.

        ``shared_pages``: leading frames the scheduler proved are still
        the pinned prefix's — re-shared by refcount, not written.
        ``num_tokens`` may be shorter than the spilled length (partial
        restore): only the leading part is written back, and the
        scheduler re-prefills the rest through the continuation path."""
        spilled = self.switcher.spilled_len(req.req_id)
        if num_tokens > spilled:
            raise ValueError(
                f"restore of req {req.req_id}: scheduler asks {num_tokens} "
                f"tokens, the switcher spilled only {spilled}")
        self.switcher.restore_kv(
            req.req_id, self.kv.k_pools, self.kv.v_pools,
            shared_prefix_pages=shared_pages, num_tokens=num_tokens)

    def discard(self, req: Request) -> None:
        """Free a failed request's host-side swap record (never restored)."""
        self.switcher.discard(req.req_id)

    def export_swap(self, req: Request):
        raise NotImplementedError(f"swap-record migration {_ROUTER}")

    def import_swap(self, req: Request, record) -> None:
        raise NotImplementedError(f"swap-record migration {_ROUTER}")

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    def sample(self, logits: torch.Tensor) -> np.ndarray:
        """Host-path sampling (prefill boundaries and the K=1 decode
        collapse path); every call forces one device->host sync.  It draws
        from the executor's generator exactly as the fused path does."""
        self.counters.inc("host_syncs")
        tok = sample(logits, self._gen, float(self.cfg.temperature),
                     self.cfg.greedy)
        return tok.to(torch.int32).cpu().numpy()
