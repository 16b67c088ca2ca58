"""Continuous-batching serving engine (Scheduler + Executor facade).

Port of ``src/repro/serve/engine.py`` for one card.  The split is the
paper's: the :class:`~repro_torch.serve.scheduler.Scheduler` is the
CVA6/OS plane (queues, admission, victim selection, page-table policy —
host-only), the :class:`~repro_torch.serve.executor.Executor` the Ara2
data plane (KV pools, persistent device page table, the CUDA kernels).
Requests flow queued -> running -> (swapped <->) running -> done;
preemption spills a whole victim sequence to host memory and restores it
later (the paper's §3.1 context switch).

The device pool reserves its LAST frame as scratch for masked decode
lanes: the engine hands ``VirtualMemory`` one frame fewer than physically
allocated.

What this slice ports is the configuration with ``prefix_cache=False``
and ``restore_patience=0`` on one card.  The engine refuses, at
construction, every config that would reach an unported path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core import CostModel, PerfCounters, VirtualMemory, VMemConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.api import ServeRequest, ServeResult, to_internal
from repro_torch.serve.detokenize import AsyncDetokenizer
from repro_torch.serve.executor import Executor
from repro_torch.serve.scheduler import Request, Scheduler, ServeConfig

__all__ = ["Engine", "Request", "ServeConfig", "ServeRequest", "ServeResult"]


def check_ported(model: TransformerLM, cfg: ServeConfig) -> None:
    """Raise ``NotImplementedError`` for any config that would reach a
    path this slice of the port does not have."""
    refused = []
    if cfg.prefix_cache:
        refused.append("prefix_cache=True (radix prefix cache: continuation "
                       "slice)")
    if cfg.restore_patience > 0:
        refused.append("restore_patience>0 (partial restore: continuation "
                       "slice)")
    if cfg.aot_buckets:
        refused.append("aot_buckets (AOT-bucketed prefill: not ported)")
    if cfg.serve_mesh not in (None, "off"):
        refused.append(f"serve_mesh={cfg.serve_mesh!r} (sharded executor: "
                       "later slice)")
    if model.cfg.family != "dense":
        refused.append(f"family {model.cfg.family!r} (later slice)")
    if refused:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(refused)
            + ".  Serve with prefix_cache=False, restore_patience=0, "
            "aot_buckets=None, serve_mesh='off' and a dense model.")


class Engine:
    """Continuous batching over a paged-KV transformer (Scheduler+Executor)."""

    def __init__(self, model: TransformerLM, params: Any, cfg: ServeConfig,
                 cost: CostModel | None = None,
                 detokenize: Callable[[Any], str] | None = None):
        check_ported(model, cfg)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.cost = cost or CostModel()
        self.counters = PerfCounters()
        self.vmem = VirtualMemory(VMemConfig(
            page_size=cfg.page_size,
            num_pages=cfg.num_pages - 1,
            max_pages_per_seq=cfg.max_pages_per_seq,
            max_seqs=cfg.max_batch,
        ))
        self.scheduler = Scheduler(cfg, self.vmem, self.cost, self.counters)
        self.executor = Executor(model, params, cfg, self.vmem, self.cost,
                                 self.counters)
        self.scheduler.attach_plane(self.executor)
        #: async detokenize/stream thread (lazy: requests without a
        #: stream_callback never spawn it)
        self.detok = AsyncDetokenizer(detokenize, counters=self.counters)
        self.scheduler.attach_stream(self.detok)
        self._next_req_id = 0

    @property
    def switcher(self):
        return self.executor.switcher

    @property
    def kv(self):
        return self.executor.kv

    def _alloc_req_id(self) -> int:
        rid = self._next_req_id
        self._next_req_id += 1
        return rid

    def submit(self, req: ServeRequest) -> int:
        """Enqueue a :class:`~repro_torch.serve.api.ServeRequest`; returns
        the request id."""
        if not isinstance(req, ServeRequest):
            raise TypeError(f"Engine.submit takes a ServeRequest, got "
                            f"{type(req).__name__}")
        if req.share_prefix:
            raise NotImplementedError(
                "share_prefix forks from a preloaded prefix: continuation "
                "slice of the PyTorch port")
        rid = req.req_id if req.req_id is not None else self._alloc_req_id()
        internal = to_internal(req, req_id=rid, cfg=self.cfg)
        self._next_req_id = max(self._next_req_id, internal.req_id + 1)
        self.scheduler.submit(internal)
        return internal.req_id

    def run(self, max_steps: int = 10_000) -> dict[int, Request]:
        """Drive until all submitted requests complete."""
        while self.scheduler.has_work and self.scheduler.step_i < max_steps:
            self.step()
        return self.scheduler.done

    def drain(self, max_steps: int = 10_000) -> dict[int, ServeResult]:
        """Drive to completion, flush the async stream thread, and return
        typed :class:`~repro_torch.serve.api.ServeResult` records."""
        self.run(max_steps)
        self.detok.drain()
        return {
            rid: ServeResult.from_request(r)
            for rid, r in self.scheduler.done.items()
        }

    def close(self) -> None:
        """Retire the stream thread deterministically (idempotent)."""
        self.detok.close()

    def step(self) -> None:
        # restore -> admit/prefill -> fused-horizon decode -> commit
        self.scheduler.step_plane()

    def stats(self) -> dict[str, Any]:
        rep = self.counters.report()
        rep["switch_stats"] = dataclasses.asdict(self.executor.switcher.stats)
        rep["pool"] = {
            "frames": self.vmem.pool.num_pages,
            "free": self.vmem.pool.num_free,
            "faults": self.vmem.pool.fault_count,
        }
        rep["modeled_ctx_switch_seconds"] = (
            self.executor.switcher.stats.modeled_seconds(self.cost)
        )
        return rep

