"""repro_torch.core — paged virtual tensor memory on the card.

Layers:
  vmem            page tables, frame allocator, translation, traces
  tlb             tree-PLRU TLB + shared-MMU trace simulator (numpy)
  faults          precise page faults, vstart resume protocol
  context_switch  preemption spill/restore of KV pages
  counters        perf counters + snapshot FIFO
  costmodel       AraOS cycle constants + H100 roofline constants
"""

from repro_torch.core.context_switch import (
    ContextSwitcher,
    SpilledState,
    SwitchStats,
)
from repro_torch.core.costmodel import CostModel
from repro_torch.core.counters import PerfCounters
from repro_torch.core.faults import OutOfPagesError, PageFault, ResumeCursor
from repro_torch.core.tlb import (
    SCALAR,
    VECTOR,
    AccessEvent,
    OverheadReport,
    SharedMMUSimulator,
    TLB,
    interleave,
)
from repro_torch.core.vmem import (
    INVALID_PAGE,
    PagePool,
    SeqState,
    VMemConfig,
    VirtualMemory,
    burst_trace,
    element_trace,
    gather_pages,
    logical_to_physical,
)

__all__ = [
    "AccessEvent",
    "ContextSwitcher",
    "CostModel",
    "INVALID_PAGE",
    "OutOfPagesError",
    "OverheadReport",
    "PageFault",
    "PagePool",
    "PerfCounters",
    "ResumeCursor",
    "SCALAR",
    "SeqState",
    "SharedMMUSimulator",
    "SpilledState",
    "SwitchStats",
    "TLB",
    "VECTOR",
    "VMemConfig",
    "VirtualMemory",
    "burst_trace",
    "element_trace",
    "gather_pages",
    "interleave",
    "logical_to_physical",
]
