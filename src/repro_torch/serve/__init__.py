"""Serving on the card: continuous batching over paged virtual memory.

Split per the AraOS architecture: the :class:`Scheduler` is the host-side
CVA6/OS plane (policy, no device tensors), the :class:`Executor` the
device-resident data plane (KV pools, persistent page table, CUDA
kernels), and :class:`Engine` the facade that wires them together.
Clients submit typed :class:`ServeRequest` records and ``drain()`` typed
:class:`ServeResult` records (:mod:`repro_torch.serve.api`).

Ported so far, on one card with the default policy: cold prefill, fused
decode horizons, preemption, the continuation paths — the radix prefix
cache, a preloaded shared prefix with ``share_prefix`` forks, and
partial restore — AOT buckets, and the multi-replica router
(:class:`ReplicaRouter` over N engines, each an :meth:`Engine.as_replica`,
with portable swap records :class:`SwapExport` and cross-replica
migration).  On the card the steps run as CUDA graphs captured when each
engine is built; :func:`disable_graphs` runs them eagerly.  On a ('kv',
'hd') serve mesh of gloo ranks (``Engine(..., mesh=...)``,
``ServeConfig.serve_mesh``) the executor splits the KV pools over the
ranks and runs its steps eagerly.  :class:`ReferenceEngine` is the
frozen seed engine the split replaced, kept as the split engine's oracle.
"""
from repro_torch.serve.api import (
    RequestTiming,
    SamplingParams,
    ServeRequest,
    ServeResult,
    StreamEvent,
    to_internal,
)
from repro_torch.serve.detokenize import AsyncDetokenizer
from repro_torch.serve.engine import Engine
from repro_torch.serve.executor import Executor, disable_graphs
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.reference import ReferenceEngine
from repro_torch.serve.router import Replica, ReplicaRouter
from repro_torch.serve.scheduler import (
    DataPlane,
    DecodePlan,
    HostOnlyPlane,
    ReplicaState,
    Request,
    RestoreFailure,
    Scheduler,
    ServeConfig,
    SwapExport,
)

__all__ = [
    "AsyncDetokenizer",
    "DataPlane",
    "DecodePlan",
    "Engine",
    "Executor",
    "HostOnlyPlane",
    "PrefixCache",
    "ReferenceEngine",
    "Replica",
    "ReplicaRouter",
    "ReplicaState",
    "Request",
    "RequestTiming",
    "RestoreFailure",
    "SamplingParams",
    "Scheduler",
    "ServeConfig",
    "ServeRequest",
    "ServeResult",
    "StreamEvent",
    "SwapExport",
    "disable_graphs",
    "to_internal",
]
