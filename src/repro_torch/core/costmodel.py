"""AraOS cycle-cost model.

The paper evaluates *latency/overhead*, not accuracy.  This module holds the
hardware constants of the evaluated system (Cheshire + CVA6 + 2-lane Ara2 on a
VCU128 at 50 MHz) and the analytical overhead-decomposition model used by the
benchmarks.  It is deliberately separated from the functional paged-memory
code: the functional path is PyTorch and runs on the card; these constants only
feed benchmark *reports*.

Paper constants (AraOS §3, §3.1):
  * system frequency 50 MHz on FPGA (950 MHz in 22 nm ASIC — not used here);
  * memory bandwidth 64 bit/cycle;
  * scalar context switch  ~1 k cycles;
  * vector context switch  ~3.2 k cycles (= scalar + ~2 k cycles to move the
    8-KiB VRF at 8 B/cycle, save + restore);
  * scheduler tick (100 Hz) costs ~20 k cycles to get back to the process;
  * TLB/cache pollution from the scheduler < 0.5 % of runtime;
  * DTLB: 2..128 PTEs, pseudo-LRU replacement, 4-KiB pages.

Constants the paper does *not* publish (page-table-walk latency, MMU hit
latency, mux arbitration cost) are explicit, documented parameters with
defaults chosen to land in the paper's reported overhead envelope (< 3.5 %
with >= 16 PTEs on matmul); the TLB-sweep benchmark reports sensitivity to
them.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Published constants
# ---------------------------------------------------------------------------

FPGA_FREQ_HZ: int = 50_000_000          # Cheshire + AraOS on VCU128
MEM_BW_BITS_PER_CYCLE: int = 64         # Cheshire 64-bit AXI data path
MEM_BW_BYTES_PER_CYCLE: int = MEM_BW_BITS_PER_CYCLE // 8

PAGE_BYTES: int = 4096                  # Sv39 4-KiB pages == AXI burst bound

VRF_BYTES: int = 8 * 1024               # 2-lane Ara2, VLEN=2048: 32 regs * 256 B
SCALAR_CTX_SWITCH_CYCLES: int = 1_000   # paper: "~1k cycles"
VECTOR_STATE_MOVE_CYCLES: int = 2 * VRF_BYTES // MEM_BW_BYTES_PER_CYCLE  # ~2k
VECTOR_CTX_SWITCH_CYCLES: int = 3_200   # paper: "~3.2k cycles" measured
SCHED_TICK_HZ: int = 100
SCHED_TICK_CYCLES: int = 20_000         # paper: "~20k cycles" back-to-process
SCHED_POLLUTION_FRAC_MAX: float = 0.005  # paper: "< 0.5% of the runtime"

POST_FAULT_FLUSH_CYCLES: int = 10       # paper: backend flush FSM "~10 cycles"

# ---------------------------------------------------------------------------
# Documented assumptions (not published in the paper)
# ---------------------------------------------------------------------------

#: Cycles for a page-table walk on a DTLB miss.  Sv39 needs up to 3 dependent
#: memory accesses; with a warm page-table-walker cache most walks hit the L1
#: (write-through, 1-cycle-ish) but cold walks go to the LLC.  40 cycles is a
#: mid-estimate; the sweep benchmark reports 20/40/80 sensitivity.
DEFAULT_PTW_CYCLES: int = 40

#: Cycles for a translation request that *hits* the DTLB (req/valid handshake
#: through the shared-MMU mux, Fig. 1).
DEFAULT_MMU_HIT_CYCLES: int = 2

#: Extra arbitration cycles when the scalar core and ADDRGEN contend for the
#: time-shared MMU in the same window.
DEFAULT_MUX_CONTENTION_CYCLES: int = 1


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Cycle-cost parameters for the AraOS overhead model."""

    freq_hz: int = FPGA_FREQ_HZ
    mem_bytes_per_cycle: int = MEM_BW_BYTES_PER_CYCLE
    page_bytes: int = PAGE_BYTES
    ptw_cycles: int = DEFAULT_PTW_CYCLES
    mmu_hit_cycles: int = DEFAULT_MMU_HIT_CYCLES
    mux_contention_cycles: int = DEFAULT_MUX_CONTENTION_CYCLES
    scalar_ctx_switch_cycles: int = SCALAR_CTX_SWITCH_CYCLES
    vector_ctx_switch_cycles: int = VECTOR_CTX_SWITCH_CYCLES
    sched_tick_cycles: int = SCHED_TICK_CYCLES
    sched_tick_hz: int = SCHED_TICK_HZ
    post_fault_flush_cycles: int = POST_FAULT_FLUSH_CYCLES

    # ---- derived helpers ---------------------------------------------------

    def seconds(self, cycles: float) -> float:
        return cycles / self.freq_hz

    def bytes_move_cycles(self, nbytes: int) -> int:
        """Cycles to stream `nbytes` through the 64-bit memory path."""
        return -(-nbytes // self.mem_bytes_per_cycle)  # ceil div

    def context_switch_cycles(self, vector_state_bytes: int) -> int:
        """Scalar switch + save & restore of `vector_state_bytes` of state.

        With the paper's VRF (8 KiB) this reproduces the measured ~3.2 k
        cycles: 1 k scalar + 2 * 1 k move.
        """
        move = 2 * self.bytes_move_cycles(vector_state_bytes)
        return self.scalar_ctx_switch_cycles + move

    def tick_overhead_fraction(self, runtime_cycles: float) -> float:
        """Fraction of runtime lost to 100-Hz scheduler ticks (no switch)."""
        runtime_s = self.seconds(runtime_cycles)
        n_ticks = runtime_s * self.sched_tick_hz
        return (n_ticks * self.sched_tick_cycles) / max(runtime_cycles, 1.0)


# ---------------------------------------------------------------------------
# NVIDIA H100 SXM roofline constants (NVIDIA data sheet, dense, 700 W)
# ---------------------------------------------------------------------------

H100_PEAK_FLOPS_BF16: float = 989e12    # tensor cores, dense
H100_HBM_BW: float = 3.35e12            # bytes/s
