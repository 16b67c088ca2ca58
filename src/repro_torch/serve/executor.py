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
  * every compute step is tallied as ``kernel_dispatches`` (the kernel
    wrappers) or ``ref_path_dispatches`` (the explicit plain-version hatch,
    ``ServeConfig.use_ref_path``).

Not ported yet (the continuation slice): forked admission, the preloaded
shared prefix and swap-record migration raise ``NotImplementedError``; AOT
buckets and the serve mesh are refused by the engine.
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
from repro_torch.models.transformer import PagedKVState, TransformerLM, sample
from repro_torch.serve.scheduler import DecodePlan, Request, ServeConfig

_CONTINUATION = ("is not ported yet: it comes with the continuation slice "
                 "of the PyTorch port (paged_copy_at, paged_prefill_attention)")


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
        batch's page-table rows."""
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

    def admit_forked_batch(self, reqs, start_lens, tail_copies):
        raise NotImplementedError(f"forked admission {_CONTINUATION}")

    def preload_prefix(self, prefix_tokens, slot: int, n: int) -> None:
        raise NotImplementedError(f"the preloaded shared prefix {_CONTINUATION}")

    def spill(self, req: Request) -> None:
        """Page-granular spill: only the victim's frames leave the device."""
        self.switcher.spill_kv(req.req_id, self.kv.k_pools, self.kv.v_pools)

    def restore(self, req: Request, num_tokens: int,
                shared_pages: list[int] | None = None) -> None:
        """Page-granular restore into freshly allocated frames (whole
        sequence: the engine refuses partial restore and shared prefixes)."""
        if shared_pages or num_tokens != self.switcher.spilled_len(req.req_id):
            raise NotImplementedError(
                f"partial or shared-prefix restore {_CONTINUATION}")
        self.switcher.restore_kv(req.req_id, self.kv.k_pools, self.kv.v_pools)

    def discard(self, req: Request) -> None:
        """Free a failed request's host-side swap record (never restored)."""
        self.switcher.discard(req.req_id)

    def export_swap(self, req: Request):
        raise NotImplementedError(
            f"swap-record migration {_CONTINUATION}, with the router")

    def import_swap(self, req: Request, record) -> None:
        raise NotImplementedError(
            f"swap-record migration {_CONTINUATION}, with the router")

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
