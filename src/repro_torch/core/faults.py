"""Page-fault and resume semantics (the vstart protocol).

AraOS handles page faults *precisely* in the middle of vector memory
instructions: the ADDRGEN stops issuing translations, the index of the faulty
element is saved into the ``vstart`` CSR, the frontend stalls until older
operations commit, and a flush FSM clears the backend (~10 cycles).  Resuming
the instruction with the recorded ``vstart`` must produce the same
architectural state as an uninterrupted run.

A CUDA kernel launched by the serving engine cannot fault mid-flight on a
software page table, so the *mechanism* does not transfer — but the
*semantics* do:

  * faults are raised by the host-side translation layer (``VirtualMemory``)
    before a kernel is dispatched with an unmapped page;
  * :class:`PageFault` carries the vstart-equivalent element index;
  * :class:`ResumeCursor` re-expresses "restart this operation at element
    vstart" for host-driven loops (prefill chunks, decode steps);
  * the property test ``faulted + resumed == uninterrupted`` is the C5
    correctness claim.
"""

from __future__ import annotations

import dataclasses


class OutOfPagesError(RuntimeError):
    """The physical pool (or slot table) cannot satisfy an allocation.

    The scheduler responds with a context switch: preempt a victim sequence,
    spill its state, retry.  Mirrors the OS reclaiming frames.
    """

    def __init__(self, requested: int, available: int, kind: str = "pages"):
        self.requested = requested
        self.available = available
        self.kind = kind
        super().__init__(
            f"out of {kind}: requested {requested}, available {available}"
        )


@dataclasses.dataclass(frozen=True)
class PageFault(Exception):
    """A precise page fault.

    ``vstart`` is the index of the first element of the current operation
    that could not be translated — the direct analogue of RVV's vstart CSR.
    Elements ``[0, vstart)`` have committed; the operation must resume at
    ``vstart`` after the fault is serviced.
    """

    seq_id: int
    logical_page: int
    vstart: int

    def __str__(self) -> str:  # Exception with dataclass needs explicit str
        return (
            f"PageFault(seq={self.seq_id}, lpn={self.logical_page}, "
            f"vstart={self.vstart})"
        )


@dataclasses.dataclass
class ResumeCursor:
    """Progress cursor for a resumable vector operation.

    Host-driven loops (chunked prefill, long copies) advance the cursor as
    elements commit; on a fault they record vstart, service the fault, and
    continue from where they stopped.  ``committed`` only moves forward —
    re-execution of committed elements is forbidden (precise-exception
    contract).
    """

    total: int
    committed: int = 0
    faults_taken: int = 0

    @property
    def done(self) -> bool:
        return self.committed >= self.total

    @property
    def remaining(self) -> int:
        return self.total - self.committed

    def advance(self, n: int) -> None:
        if n < 0:
            raise ValueError("cannot advance backwards")
        if self.committed + n > self.total:
            raise ValueError("advance past end of operation")
        self.committed += n

    def record_fault(self, fault: PageFault) -> None:
        """Advance to the faulting element: [committed, vstart) committed."""
        if fault.vstart < 0:
            raise ValueError("negative vstart")
        self.advance(fault.vstart)
        self.faults_taken += 1
