"""FROZEN seed serving engine — the pre-split reference implementation.

The monolithic engine the Scheduler/Executor split replaced (see
:mod:`repro_torch.serve.engine`), ported method for method with the same
policy.  It is kept for two purposes only:

  * the tests hold the split :class:`~repro_torch.serve.Engine` to it,
    token for token and counter for counter, on a mixed
    prefill/decode/preempt workload and on forked shared-prefix
    workloads (the seed teacher-forces each forked prompt one decode step
    at a time, where the split engine runs one continuation prefill);
  * ``chip_smoke.py`` measures its two hot-path pathologies on the card:
    a whole page-table upload each decode step, and a stack and reshape
    of both whole pools on every spill and restore.

Do not extend it; new serving work goes through Scheduler/Executor.  It
has no CUDA graphs, no mesh and no refusals of its own.

Responsibilities mapped from the paper:
  * page-table ownership and on-demand page allocation (the MMU + OS kernel);
  * page faults during decode (append_tokens) with precise accounting;
  * PREEMPTION when the physical pool is exhausted: a victim's vector state
    (its KV pages + sampler state + progress cursor) is spilled to a swap
    area and restored later — the §3.1 context switch, measured in real bytes
    and modeled cycles;
  * scheduler quanta and tick accounting (100 Hz analogue);
  * perf counters + snapshot FIFO (the paper's measurement infrastructure).

The engine runs a fixed ``max_batch`` of device-side slots; requests flow
queued -> running -> (swapped <->) running -> done.  Decode always executes
the full slot array (inactive slots are masked by unmapped page-table rows —
their writes land in the reserved scratch frame).

The device pool reserves its LAST frame as scratch: the engine hands
``VirtualMemory`` one frame fewer than physically allocated.  Every tensor
lives on ``model.device``; the model's serve entry points and the
switcher's restore write the pools in place.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core import (
    INVALID_PAGE,
    ContextSwitcher,
    CostModel,
    OutOfPagesError,
    PerfCounters,
    VirtualMemory,
    VMemConfig,
)
from repro_torch.models.transformer import PagedKVState, TransformerLM, sample
from repro_torch.serve.scheduler import Request, ServeConfig


class ReferenceEngine:
    """Continuous batching over a paged-KV transformer (frozen seed)."""

    def __init__(self, model: TransformerLM, params: Any, cfg: ServeConfig,
                 cost: CostModel | None = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.cost = cost or CostModel()
        self.device = model.device
        # the device pool has num_pages frames; the allocator sees one less
        # (last frame = scratch for masked writes)
        self.vmem = VirtualMemory(VMemConfig(
            page_size=cfg.page_size,
            num_pages=cfg.num_pages - 1,
            max_pages_per_seq=cfg.max_pages_per_seq,
            max_seqs=cfg.max_batch,
        ))
        self.switcher = ContextSwitcher(self.vmem, self.cost, page_axis=1)
        self.counters = PerfCounters()
        self.kv = model.init_kv_state(
            cfg.max_batch, cfg.num_pages, cfg.page_size, cfg.max_pages_per_seq
        )
        self.queue: deque[Request] = deque()
        self.swapped: deque[int] = deque()
        self._swap_requests: dict[int, Request] = {}
        self.running: dict[int, Request] = {}    # req_id -> Request
        self.done: dict[int, Request] = {}
        self._slot_of: dict[int, int] = {}       # req_id -> device slot
        self._step_i = 0
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        #: shared-prefix ("system prompt") support: one resident sequence
        #: whose whole pages are refcount-shared into forked requests.
        #: KV pages are append-only, so shared pages are never rewritten —
        #: copy-on-write degenerates to copy-the-tail-page at fork time.
        self.PREFIX_ID = -1
        self._prefix_len = 0

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def preload_prefix(self, prefix_tokens: np.ndarray) -> None:
        """Prefill a resident shared prefix (system-prompt caching).

        Subsequent ``submit(req)`` of ``share_prefix`` requests fork their
        page tables from it: whole prefix pages are shared by refcount, only
        the partial tail page is copied.
        """
        assert self.vmem.num_seqs == 0, "preload before serving"
        n = len(prefix_tokens)
        self.vmem.map_seq(self.PREFIX_ID, n)
        slot = self.vmem.seq(self.PREFIX_ID).slot
        pt_row = self.vmem.device_page_table(device=self.device)[[slot]]
        state = PagedKVState(
            self.kv.k_pools, self.kv.v_pools, pt_row,
            torch.zeros((1,), dtype=torch.int32, device=self.device),
        )
        tokens = np.asarray(prefix_tokens, np.int32)[None, :]
        pad = (-n) % self.cfg.page_size
        if pad:
            tokens = np.pad(tokens, ((0, 0), (0, pad)))
        _, new_state = self.model.prefill(
            self.params, self._tensor(tokens), self._tensor([n]), state,
        )
        self.kv = self.kv._replace(
            k_pools=new_state.k_pools, v_pools=new_state.v_pools
        )
        self._prefix_len = n
        self.counters.inc("prefix_tokens", n)

    def _admit_forked(self, req: Request) -> None:
        """Fork the shared prefix and teacher-force the request's own
        prompt through decode steps (continuation prefill)."""
        state = self.vmem.fork_seq(self.PREFIX_ID, req.req_id,
                                   self._prefix_len)
        slot = state.slot
        # copy the partial tail page (whole pages are shared read-only)
        parent = self.vmem.seq(self.PREFIX_ID)
        page = self.cfg.page_size
        if self._prefix_len % page:
            tail_idx = self._prefix_len // page
            src = parent.pages[tail_idx]
            dst = state.pages[tail_idx]
            for pools in (self.kv.k_pools, self.kv.v_pools):
                pools[:, dst].copy_(pools[:, src])
        b = self.cfg.max_batch
        logits = None
        for tok in np.asarray(req.prompt, np.int32):
            self.vmem.append_tokens(req.req_id, 1)
            pre_lens = np.zeros((b,), np.int32)
            pre_lens[slot] = self.vmem.seq_len(req.req_id) - 1
            tokens = np.zeros((b,) + np.shape(tok), np.int32)
            tokens[slot] = tok
            st = PagedKVState(
                self.kv.k_pools, self.kv.v_pools,
                self._table_only(slot), self._tensor(pre_lens),
            )
            logits, new_state = self.model.decode_step(
                self.params, self._tensor(tokens), st
            )
            self.kv = self.kv._replace(
                k_pools=new_state.k_pools, v_pools=new_state.v_pools
            )
        req.status = "running"
        req.prefix_len = self._prefix_len
        req.output.append(np.asarray(self._sample(logits)[slot]))
        self.running[req.req_id] = req
        self._slot_of[req.req_id] = slot
        self.counters.inc("forked_admissions")

    def _table_only(self, slot: int) -> torch.Tensor:
        """Page table with every row but `slot` masked (single-seq step)."""
        full = self.vmem.device_page_table(device=self.device)
        masked = torch.full_like(full, INVALID_PAGE)
        masked[slot] = full[slot]
        return masked

    def submit(self, req: Request) -> None:
        req.arrival = self._step_i
        self.queue.append(req)
        self.counters.inc("submitted")
        self.counters.snapshot("submit", req.req_id)

    def run(self, max_steps: int = 10_000) -> dict[int, Request]:
        """Drive until all submitted requests complete."""
        while (self.queue or self.running or self.swapped) and (
            self._step_i < max_steps
        ):
            self.step()
        return self.done

    def step(self) -> None:
        self._step_i += 1
        if self._step_i % self.cfg.tick_every_steps == 0:
            # 100 Hz scheduler tick accounting (paper §3.1)
            self.counters.inc("ticks")
            self.counters.inc(
                "modeled_tick_cycles", self.cost.sched_tick_cycles
            )
        self._try_restore()
        self._admit()
        if self.running:
            self._decode_once()

    # ------------------------------------------------------------------
    # admission (prefill)
    # ------------------------------------------------------------------

    def _required_pages(self, req: Request) -> int:
        return self.vmem.config.pages_for(len(req.prompt) + 1)

    def _admit(self) -> None:
        admitted: list[Request] = []
        while self.queue and len(self.running) + len(admitted) < self.cfg.max_batch:
            req = self.queue[0]
            need = self._required_pages(req)
            if need > self.vmem.pool.num_free:
                if not self._preempt_for(need):
                    break                      # nothing left to preempt
            if req.share_prefix:
                try:
                    self._admit_forked(req)
                except OutOfPagesError:
                    break
                self.queue.popleft()
                continue
            try:
                self.vmem.map_seq(req.req_id, len(req.prompt))
            except OutOfPagesError:
                break
            self.queue.popleft()
            admitted.append(req)
        if not admitted:
            return
        self._prefill(admitted)

    def _prefill(self, reqs: list[Request]) -> None:
        smax = max(len(r.prompt) for r in reqs)
        page = self.cfg.page_size
        smax = -(-smax // page) * page            # burst-align
        tok_shape = (len(reqs), smax) + reqs[0].prompt.shape[1:]
        tokens = np.zeros(tok_shape, np.int32)
        lens = np.array([len(r.prompt) for r in reqs], np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : len(r.prompt)] = r.prompt
        # page-table rows aligned to the prefill batch
        slots = [self.vmem.seq(r.req_id).slot for r in reqs]
        pt_admit = self.vmem.device_page_table(device=self.device)[slots]
        state = PagedKVState(
            self.kv.k_pools, self.kv.v_pools, pt_admit,
            torch.zeros((len(reqs),), dtype=torch.int32, device=self.device),
        )
        with self.counters.timer("prefill"):
            logits, new_state = self.model.prefill(
                self.params, self._tensor(tokens), self._tensor(lens), state
            )
            self._block()   # the timer measures execution, not the launch
        self.kv = self.kv._replace(
            k_pools=new_state.k_pools, v_pools=new_state.v_pools
        )
        first = self._sample(logits)
        for i, r in enumerate(reqs):
            r.status = "running"
            r.output.append(np.asarray(first[i]))
            self.running[r.req_id] = r
            self._slot_of[r.req_id] = slots[i]
        self.counters.inc("prefill_tokens", int(lens.sum()))
        self.counters.inc("prefill_translation_bursts", int(
            sum(self.vmem.config.pages_for(int(x)) for x in lens)
        ))
        self.counters.snapshot("prefill", [r.req_id for r in reqs])

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _decode_once(self) -> None:
        cfg = self.cfg
        # 1. fault in pages for every running sequence's next position
        #    (idempotent: a restore may already cover the position)
        for req_id in list(self.running):
            r = self.running.get(req_id)
            if r is None:
                continue  # spilled by an earlier victim selection this step
            grow = r.total_len - self.vmem.seq_len(req_id)
            if grow <= 0:
                continue
            try:
                faults = self.vmem.append_tokens(req_id, grow)
            except OutOfPagesError:
                if not self._preempt_for(1, protect=req_id):
                    continue  # stays running; retried next step
                faults = self.vmem.append_tokens(req_id, grow)
            if faults:
                self.counters.inc("page_faults", len(faults))
                self.counters.inc(
                    "modeled_fault_cycles",
                    len(faults) * (self.cost.ptw_cycles
                                   + self.cost.post_fault_flush_cycles),
                )
        # 2. build the full-slot decode batch
        if not self.running:
            return  # everything got preempted this step
        b = cfg.max_batch
        tokens = np.zeros((b,) + np.shape(
            next(iter(self.running.values())).output[-1]
        ), np.int32)
        pre_lens = np.zeros((b,), np.int32)
        for req_id, r in self.running.items():
            slot = self._slot_of[req_id]
            tokens[slot] = r.output[-1]
            pre_lens[slot] = r.total_len - 1   # position of the new token
        # mask page-table rows of slots that are NOT running this step:
        # mapped-but-idle sequences (e.g. the resident shared prefix) must
        # not receive the inactive-lane scratch writes — with a valid row
        # the guard would route them into a LIVE frame (position 0 of the
        # prefix page!) instead of the reserved scratch row.  The seed's
        # pathology, kept: the WHOLE table goes to the device, comes back,
        # and goes again every step.
        ptab = self.vmem.device_page_table(device=self.device).cpu().numpy()
        active_slots = set(self._slot_of.values())
        for sl in range(b):
            if sl not in active_slots:
                ptab[sl] = INVALID_PAGE
        state = PagedKVState(
            self.kv.k_pools, self.kv.v_pools,
            self._tensor(ptab), self._tensor(pre_lens),
        )
        with self.counters.timer("decode"):
            logits, new_state = self.model.decode_step(
                self.params, self._tensor(tokens), state
            )
            self._block()
        self.kv = self.kv._replace(
            k_pools=new_state.k_pools, v_pools=new_state.v_pools
        )
        nxt = self._sample(logits)
        self.counters.inc("decode_tokens", len(self.running))
        self.counters.inc("decode_translations", len(self.running))
        # 3. commit sampled tokens, retire finished requests
        for req_id in list(self.running):
            r = self.running[req_id]
            slot = self._slot_of[req_id]
            r.output.append(np.asarray(nxt[slot]))
            if len(r.output) >= r.max_new_tokens:
                r.status = "done"
                self.done[req_id] = r
                del self.running[req_id]
                del self._slot_of[req_id]
                self.vmem.unmap_seq(req_id)
                self.counters.inc("completed")
                self.counters.snapshot("done", req_id)

    # ------------------------------------------------------------------
    # preemption / restore (context switches)
    # ------------------------------------------------------------------

    def _preempt_for(self, pages_needed: int, protect: int | None = None) -> bool:
        """Spill victims until `pages_needed` frames are free."""
        while self.vmem.pool.num_free < pages_needed:
            victims = [
                r for rid, r in self.running.items() if rid != protect
            ]
            if not victims:
                return False
            # policy: most remaining work (cheapest to delay)
            victim = max(victims, key=lambda r: (r.remaining, -r.arrival))
            self._spill(victim)
        return True

    def _spill(self, req: Request) -> None:
        # KV pages of both pools travel together (single vector state):
        # the seed stacks BOTH WHOLE pools for every spill
        stacked = torch.stack([self.kv.k_pools, self.kv.v_pools])  # [2, L, P, ...]
        self.switcher.spill(
            req.req_id,
            stacked.reshape((-1,) + tuple(self.kv.k_pools.shape[1:])),
            extra_state={"output": list(req.output)},
        )
        req.status = "swapped"
        self.swapped.append(req.req_id)
        self._swap_requests[req.req_id] = req
        del self.running[req.req_id]
        del self._slot_of[req.req_id]
        self.counters.inc("preemptions")
        self.counters.snapshot("preempt", req.req_id)

    def _try_restore(self) -> None:
        for _ in range(len(self.swapped)):
            req_id = self.swapped[0]
            if len(self.running) >= self.cfg.max_batch:
                return
            if not self.switcher.can_restore(req_id):
                return
            self.swapped.popleft()
            stacked = torch.stack([self.kv.k_pools, self.kv.v_pools])
            flat = stacked.reshape((-1,) + tuple(self.kv.k_pools.shape[1:]))
            flat, extra = self.switcher.restore(req_id, flat)
            restored = flat.reshape(stacked.shape)
            # the pools become views of the new stacked tensor (each
            # contiguous, as the kernels' wrappers want)
            self.kv = self.kv._replace(
                k_pools=restored[0], v_pools=restored[1]
            )
            req = self._swap_requests.pop(req_id)
            req.status = "running"
            req.output = extra["output"]
            self.running[req_id] = req
            self._slot_of[req_id] = self.vmem.seq(req_id).slot
            self.counters.inc("restores")
            self.counters.snapshot("restore", req_id)

    # ------------------------------------------------------------------
    # sampling + stats
    # ------------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy argmax on the device, or a temperature draw from the
        engine's generator (seeded by ``cfg.seed``: the same seed gives
        the same stream; ``jax.random``'s cannot be reproduced)."""
        tok = sample(logits, self._gen, float(self.cfg.temperature),
                     self.cfg.greedy)
        return tok.to(torch.int32).cpu().numpy()

    def stats(self) -> dict[str, Any]:
        rep = self.counters.report()
        rep["switch_stats"] = dataclasses.asdict(self.switcher.stats)
        rep["pool"] = {
            "frames": self.vmem.pool.num_pages,
            "free": self.vmem.pool.num_free,
            "faults": self.vmem.pool.fault_count,
        }
        rep["modeled_ctx_switch_seconds"] = self.switcher.stats.modeled_seconds(
            self.cost
        )
        return rep

    # ------------------------------------------------------------------
    # device helpers
    # ------------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                               device=self.device)

    def _block(self) -> None:
        """Wait for the card (JAX's ``block_until_ready``); nothing on the
        CPU."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
