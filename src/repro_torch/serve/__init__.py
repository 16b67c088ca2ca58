"""Serving on the card: continuous batching over paged virtual memory.

Split per the AraOS architecture: the :class:`Scheduler` is the host-side
CVA6/OS plane (policy, no device tensors), the :class:`Executor` the
device-resident data plane (KV pools, persistent page table, CUDA
kernels), and :class:`Engine` the facade that wires them together.
Clients submit typed :class:`ServeRequest` records and ``drain()`` typed
:class:`ServeResult` records (:mod:`repro_torch.serve.api`).

Ported so far: one replica on one card, with the radix prefix cache and
partial restore off.  The router, the sharded executor and the
continuation paths (forks, prefix cache, partial restore) are later
slices.
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
from repro_torch.serve.executor import Executor
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import (
    DataPlane,
    DecodePlan,
    HostOnlyPlane,
    Request,
    Scheduler,
    ServeConfig,
)

__all__ = [
    "AsyncDetokenizer",
    "DataPlane",
    "DecodePlan",
    "Engine",
    "Executor",
    "HostOnlyPlane",
    "PrefixCache",
    "Request",
    "RequestTiming",
    "SamplingParams",
    "Scheduler",
    "ServeConfig",
    "ServeRequest",
    "ServeResult",
    "StreamEvent",
    "to_internal",
]
