"""Quickstart: the paged virtual-memory subsystem in five steps, on the card.

The paper's core loop end to end, the same steps, constants and printed
lines as the JAX package's ``examples/quickstart.py``:

  1. map a sequence into paged memory (page tables, frame allocator);
  2. write through translation with one burst per page (C2-burst,
     ``ops.paged_copy``);
  3. read back with per-element translation (C2-indexed,
     ``ops.paged_gather``) and count the asymmetry the paper measures on
     spmv/canneal;
  4. take a page fault mid-stream, service it, resume at vstart (C5);
  5. replay the recorded address trace through the DTLB simulator across
     the 2..32-entry sweep (Fig. 2 machinery).

Run on the card:  ``PYTHONPATH=src python -m repro_torch.launch.quickstart``
(raises when there is no CUDA device); ``--device cpu`` runs the plain
PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    AccessEvent,
    PageFault,
    ResumeCursor,
    SharedMMUSimulator,
    VECTOR,
    VMemConfig,
    VirtualMemory,
    burst_trace,
    element_trace,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

PAGE = 8


def main(device: str | torch.device | None = None) -> None:
    dev = resolve_device(device)
    vm = VirtualMemory(VMemConfig(
        page_size=PAGE, num_pages=64, max_pages_per_seq=16, max_seqs=2,
    ))

    # -- 1. map a 50-token sequence ------------------------------------
    vm.map_seq(0, 50)
    print(f"mapped seq 0: {len(vm.seq(0).pages)} physical pages "
          f"{vm.seq(0).pages}")

    # -- 2. unit-stride write: one translation per page burst -----------
    src = torch.arange(50 * 4, dtype=torch.float32, device=dev).reshape(
        1, 50, 4)
    pool = torch.zeros((64, PAGE, 4), device=dev)
    table = vm.device_page_table(dev)
    ops.paged_copy(src, pool, table[:1],
                   torch.tensor([50], dtype=torch.int32, device=dev),
                   page_size=PAGE)
    bursts = burst_trace(np.arange(50), PAGE)
    print(f"unit-stride write of 50 tokens -> {bursts.size} translations "
          f"(one per page burst)")

    # -- 3. indexed gather: one translation per ELEMENT ------------------
    idx = np.array([3, 49, 0, 17, 17, 33, 8, 9])
    positions = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    gathered = ops.paged_gather(pool, table[0], positions, page_size=PAGE)
    elems = element_trace(idx, PAGE)
    print(f"indexed gather of {idx.size} elements -> {elems.size} "
          f"translations (the spmv/canneal penalty, paper §3.2)")
    if not torch.equal(gathered, src[0, positions.long()]):
        raise AssertionError("the gather did not read back what was written")

    # -- 4. page fault + vstart resume -----------------------------------
    cursor = ResumeCursor(total=80)
    out = np.zeros(80, np.float32)
    data = np.arange(80, dtype=np.float32)
    while not cursor.done:
        want = np.arange(cursor.committed, 80)
        try:
            vm.translate(0, want)
        except PageFault as f:
            good = want[: f.vstart]
            if good.size:
                out[good] = data[good]
            cursor.record_fault(f)
            vm.append_tokens(0, PAGE)  # service: allocate one more page
            continue
        out[want] = data[want]
        cursor.advance(want.size)
    print(f"faulted copy finished after {cursor.faults_taken} page faults; "
          f"output exact: {bool((out == data).all())}")

    # -- 5. DTLB sweep over the real trace --------------------------------
    trace = element_trace(np.tile(np.arange(80), 20), PAGE)
    print("\nDTLB sweep (trace from step 4's address stream):")
    for entries in (2, 4, 8, 16, 32):
        sim = SharedMMUSimulator(entries)
        rep = sim.run([AccessEvent(VECTOR, int(v), slack=5.0) for v in trace])
        print(f"  {entries:3d} entries: {rep.misses:4d} misses, "
              f"visible stall {rep.ara2_cycles:7.0f} cycles")


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    main(ap.parse_args().device)


if __name__ == "__main__":
    _cli()
