"""Continuous-batching serving engine (Scheduler + Executor facade).

Port of ``src/repro/serve/engine.py``.  The split is the
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

Ported: one replica on one card with the default policy — the radix
prefix cache (a plain admission whose prompt starts with a resident run
shares its whole pages and prefills only the divergent chunk), a
preloaded shared prefix with ``share_prefix`` forks, and partial restore,
all through the executor's batched continuation prefill, and AOT buckets
(``ServeConfig.aot_buckets``: a prefill and a continuation program per
bucket).  One engine is one replica: :meth:`Engine.as_replica` binds it
into a :class:`~repro_torch.serve.router.ReplicaRouter`, which places
requests from one global admission queue over N engines (they may share
one model and one weight set) and drives each through the same
``Scheduler.step_plane`` loop :meth:`Engine.step` runs — this engine is
the router's N=1 instance.  On the card the executor captures its step
programs as CUDA graphs when it is built (each decode horizon, the K=1
step, the bucket programs) and replays them;
``serve.executor.disable_graphs()`` runs the same steps eagerly.  The
dense, MoE, VLM and audio families serve (audio requests carry ``[len,
K]`` codebook prompts and get ``[K]`` tokens a step).  On a ('kv',
'hd') serve mesh (``Engine(..., mesh=...)`` or ``ServeConfig.serve_mesh``)
every rank of the mesh builds the same engine and drives the same
schedule; only the executor's KV pools are split, and the kernels run on
each rank's slice.  The engine refuses, at construction, AOT buckets
with an audio model (the JAX engine fails to build them) and recurrent
families, which the JAX engine does not serve either: they decode
through their model's own ``prefill`` / ``decode_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.core import CostModel, PerfCounters, VirtualMemory, VMemConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.api import ServeRequest, ServeResult, to_internal
from repro_torch.serve.detokenize import AsyncDetokenizer
from repro_torch.serve.executor import Executor
from repro_torch.serve.scheduler import Request, Scheduler, ServeConfig

__all__ = ["Engine", "Request", "ServeConfig", "ServeRequest", "ServeResult"]

#: families with a recurrent state instead of a paged KV cache; the engine
#: does not serve them (nor does the JAX engine)
RECURRENT_FAMILIES = ("rwkv6", "hybrid_rglru")
#: the JAX launcher's words (``src/repro/launch/serve.py``)
RECURRENT_REFUSAL = ("engine drives paged-KV transformers; recurrent "
                     "families decode via model.decode_step (see examples/)")


def _lower(req: ServeRequest, next_id: Callable[[], int],
           cfg: ServeConfig) -> Request:
    """Lower a client submission to the scheduler-plane :class:`Request`
    (the engine's and the router's ``submit``).  :class:`ServeRequest` is
    the only accepted public type; scheduler-plane harnesses submit
    internal ``Request`` objects through ``Scheduler.submit``."""
    if not isinstance(req, ServeRequest):
        raise TypeError(
            f"Engine/ReplicaRouter.submit takes a ServeRequest, got "
            f"{type(req).__name__}; scheduler-plane harnesses submit "
            "internal Requests via Scheduler.submit")
    rid = req.req_id if req.req_id is not None else next_id()
    return to_internal(req, req_id=rid, cfg=cfg)


def check_ported(model: TransformerLM) -> None:
    """Raise ``NotImplementedError`` for a recurrent family, which the
    engine does not serve."""
    if model.cfg.family in RECURRENT_FAMILIES:
        raise NotImplementedError(f"{model.cfg.name}: {RECURRENT_REFUSAL}")


class Engine:
    """Continuous batching over a paged-KV transformer (Scheduler+Executor)."""

    def __init__(self, model: TransformerLM, params: Any, cfg: ServeConfig,
                 cost: CostModel | None = None, mesh=None,
                 detokenize: Callable[[Any], str] | None = None):
        """``mesh``: a ('kv', 'hd') serve mesh
        (:func:`repro_torch.launch.mesh.make_host_serve_mesh`); when
        omitted it is resolved from ``cfg.serve_mesh``
        (:meth:`ServeConfig.build_mesh`, on the model's device type).  Only
        the Executor's KV pools split over it; the Scheduler is host policy
        and needs no change.  A rank the mesh leaves out raises the model's
        ``ValueError``.  ``detokenize``: token->text hook for the async
        stream thread."""
        check_ported(model)
        if mesh is None:
            mesh = cfg.build_mesh(model.cfg, device=model.device)
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
                                 self.counters, mesh=mesh)
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
    def PREFIX_ID(self):
        return self.scheduler.PREFIX_ID

    @property
    def kv(self):
        return self.executor.kv

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def running(self):
        return self.scheduler.running

    @property
    def swapped(self):
        return self.scheduler.swapped

    @property
    def done(self):
        return self.scheduler.done

    def preload_prefix(self, prefix_tokens) -> None:
        """Prefill a resident shared prefix (system-prompt caching).

        Later ``share_prefix`` requests fork their page tables from it:
        whole prefix pages are shared by refcount, only the partial tail
        page is copied.  The prefix also enters the radix cache (after its
        KV is committed), so plain prompts that merely start with it share
        its whole pages too."""
        if self.vmem.num_seqs:
            raise RuntimeError("preload the prefix before serving")
        prefix = np.asarray(prefix_tokens, np.int32)
        n = len(prefix)
        self.vmem.map_seq(self.scheduler.PREFIX_ID, n)
        slot = self.vmem.seq(self.scheduler.PREFIX_ID).slot
        self.executor.preload_prefix(prefix, slot, n)
        self.scheduler.prefix_len = n
        self.scheduler.register_resident(self.scheduler.PREFIX_ID, prefix)

    def _alloc_req_id(self) -> int:
        rid = self._next_req_id
        self._next_req_id += 1
        return rid

    def submit(self, req: ServeRequest) -> int:
        """Enqueue a :class:`~repro_torch.serve.api.ServeRequest`; returns
        the request id."""
        internal = _lower(req, self._alloc_req_id, self.cfg)
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

    def as_replica(self, replica_id: int):
        """This engine as one replica of a
        :class:`~repro_torch.serve.router.ReplicaRouter` (its Scheduler and
        Executor are already wired and share one counter set)."""
        from repro_torch.serve.router import Replica
        return Replica.from_engine(self, replica_id)

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

