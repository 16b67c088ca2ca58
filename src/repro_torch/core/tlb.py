"""Software TLB model with tree-PLRU replacement + trace-driven simulator.

CVA6's DTLB is fully associative with pseudo-LRU replacement; the paper sweeps
it from 2 to 128 entries and attributes the residual overhead at 128 entries
(< 1 %) to PLRU's non-optimality.  :class:`TLB` reproduces that structure
exactly (tree-PLRU over a fully-associative array), and
:class:`SharedMMUSimulator` replays *interleaved* scalar/vector address traces
through one shared TLB — the time-multiplexed MMU of Fig. 1 — producing the
three-way overhead decomposition of Fig. 2(b,c,d):

  1. CVA6 overhead   — visible stalls on scalar-issued translations;
  2. Ara2 overhead   — visible stalls on vector-issued translations;
  3. mux + pollution — arbitration cycles when both requesters contend, plus
     scheduler-induced TLB pollution.

The latency-hiding effect (paper C4: "Ara2's FPU computation can overlap and
hide the stalls from DTLB misses") is modeled per event: each translation
carries ``slack`` cycles of concurrent compute that can absorb the miss
penalty; the *visible* stall is ``max(0, penalty - slack)``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core.costmodel import CostModel

SCALAR = 0  # CVA6-issued translation
VECTOR = 1  # Ara2/ADDRGEN-issued translation


class TLB:
    """Fully-associative TLB with tree-PLRU replacement.

    ``entries`` must be a power of two (CVA6 configs: 2..128).  The PLRU tree
    has ``entries - 1`` internal nodes stored as a flat heap; on an access the
    bits along the leaf's path are pointed *away* from it, and the victim is
    found by following the bits from the root.
    """

    def __init__(self, entries: int):
        if entries < 1 or (entries & (entries - 1)) != 0:
            raise ValueError(f"TLB entries must be a power of two, got {entries}")
        self.entries = entries
        self._tags = np.full(entries, -1, dtype=np.int64)
        self._plru = np.zeros(max(entries - 1, 1), dtype=np.int8)
        self.hits = 0
        self.misses = 0

    # ---- PLRU tree helpers ----------------------------------------------

    def _touch(self, way: int) -> None:
        """Point every node on the path away from `way` (MRU update)."""
        if self.entries == 1:
            return
        node = 0
        lo, hi = 0, self.entries
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if way < mid:  # leaf in left subtree -> point right (away)
                self._plru[node] = 1
                node = 2 * node + 1
                hi = mid
            else:          # leaf in right subtree -> point left (away)
                self._plru[node] = 0
                node = 2 * node + 2
                lo = mid
        assert lo == way

    def _victim(self) -> int:
        """Follow the PLRU bits from the root to the victim leaf."""
        if self.entries == 1:
            return 0
        node = 0
        lo, hi = 0, self.entries
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self._plru[node] == 0:  # points left
                node = 2 * node + 1
                hi = mid
            else:
                node = 2 * node + 2
                lo = mid
        return lo

    # ---- public API -------------------------------------------------------

    def access(self, vpn: int) -> bool:
        """Look up ``vpn``; fill on miss. Returns True on hit."""
        hit_ways = np.nonzero(self._tags == vpn)[0]
        if hit_ways.size:
            self.hits += 1
            self._touch(int(hit_ways[0]))
            return True
        self.misses += 1
        # Hardware fills invalid ways before consulting PLRU for a victim.
        invalid = np.nonzero(self._tags == -1)[0]
        way = int(invalid[0]) if invalid.size else self._victim()
        self._tags[way] = vpn
        self._touch(way)
        return False

    def flush(self) -> None:
        """sfence.vma equivalent — also models scheduler TLB pollution."""
        self._tags[:] = -1
        self._plru[:] = 0

    def pollute(self, n: int, rng: np.random.Generator) -> None:
        """Evict via ``n`` accesses to fresh VPNs (scheduler interference)."""
        base = -2 - int(rng.integers(0, 2**31))
        h, m = self.hits, self.misses
        for i in range(n):
            self.access(base - i)
        self.hits, self.misses = h, m  # pollution is not workload traffic

    @property
    def resident(self) -> set[int]:
        return {int(t) for t in self._tags if t >= 0}


@dataclasses.dataclass(frozen=True)
class AccessEvent:
    """One translation request issued to the shared MMU.

    ``slack``: cycles of concurrent vector compute available to hide a miss
    on this request (0 for fully exposed scalar loads in serial sections).
    """

    source: int  # SCALAR | VECTOR
    vpn: int
    slack: float = 0.0


@dataclasses.dataclass
class OverheadReport:
    """Fig. 2-style decomposition (all in cycles, plus totals)."""

    cva6_cycles: float = 0.0
    ara2_cycles: float = 0.0
    mux_pollution_cycles: float = 0.0
    translations: int = 0
    hits: int = 0
    misses: int = 0
    scalar_misses: int = 0
    vector_misses: int = 0

    @property
    def total_cycles(self) -> float:
        return self.cva6_cycles + self.ara2_cycles + self.mux_pollution_cycles

    def overhead_fraction(self, baseline_cycles: float) -> float:
        """Overhead relative to the bare-metal (no-translation) runtime."""
        return self.total_cycles / max(baseline_cycles, 1.0)

    def decomposed_fractions(self, baseline_cycles: float) -> dict[str, float]:
        b = max(baseline_cycles, 1.0)
        return {
            "cva6": self.cva6_cycles / b,
            "ara2": self.ara2_cycles / b,
            "mux_pollution": self.mux_pollution_cycles / b,
            "total": self.total_cycles / b,
        }


class SharedMMUSimulator:
    """Replay an interleaved scalar/vector trace through one shared TLB.

    Mirrors the time-multiplexed MMU: a single TLB serves both requesters;
    adjacent requests from *different* sources pay an arbitration cost
    (``mux_contention_cycles``).  Hit latency is pipelined away for the
    vector unit (translation happens ahead of the burst) but counts for the
    scalar core only when it has no slack.
    """

    def __init__(self, tlb_entries: int, cost: CostModel | None = None,
                 seed: int = 0):
        self.tlb = TLB(tlb_entries)
        self.cost = cost or CostModel()
        self._rng = np.random.default_rng(seed)

    def run(
        self,
        events: Iterable[AccessEvent],
        *,
        pollution_evictions_per_tick: int = 0,
        num_ticks: int = 0,
    ) -> OverheadReport:
        rep = OverheadReport()
        prev_source: int | None = None
        prev_missed = False
        events = list(events)
        # Scheduler pollution: spread tick evictions evenly across the trace.
        tick_every = len(events) // num_ticks if num_ticks else 0
        for i, ev in enumerate(events):
            if tick_every and i and i % tick_every == 0:
                self.tlb.pollute(pollution_evictions_per_tick, self._rng)
                rep.mux_pollution_cycles += (
                    pollution_evictions_per_tick * self.cost.ptw_cycles * 0.5
                )
            rep.translations += 1
            hit = self.tlb.access(ev.vpn)
            penalty = self.cost.mmu_hit_cycles if hit else (
                self.cost.mmu_hit_cycles + self.cost.ptw_cycles
            )
            if hit:
                rep.hits += 1
            else:
                rep.misses += 1
                if ev.source == SCALAR:
                    rep.scalar_misses += 1
                else:
                    rep.vector_misses += 1
            visible = max(0.0, penalty - ev.slack)
            if ev.source == SCALAR:
                rep.cva6_cycles += visible
            else:
                rep.ara2_cycles += visible
            # Arbitration is only paid when the other requester arrives
            # while the shared MMU is still busy with a page-table walk
            # (hits are single-cycle and pipeline through the mux).
            if (prev_source is not None and prev_source != ev.source
                    and prev_missed):
                rep.mux_pollution_cycles += self.cost.mux_contention_cycles
            prev_source = ev.source
            prev_missed = not hit
        return rep


def interleave(
    scalar_vpns: Sequence[int],
    vector_vpns: Sequence[int],
    *,
    scalar_slack: float,
    vector_slack: float,
    ratio: int = 1,
) -> Iterator[AccessEvent]:
    """Interleave scalar and vector translation streams.

    ``ratio`` scalar events are issued per vector event (matmul interleaves
    scalar pointer/loop loads with vector row bursts — the paper picked
    matmul precisely because it "heavily requires the cooperation of the
    scalar core").
    """
    si, vi = 0, 0
    while si < len(scalar_vpns) or vi < len(vector_vpns):
        for _ in range(ratio):
            if si < len(scalar_vpns):
                yield AccessEvent(SCALAR, int(scalar_vpns[si]), scalar_slack)
                si += 1
        if vi < len(vector_vpns):
            yield AccessEvent(VECTOR, int(vector_vpns[vi]), vector_slack)
            vi += 1
