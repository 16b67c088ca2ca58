"""Performance counters + event snapshots.

The paper adds "a measurement infrastructure composed of performance counters
and FIFOs to create snapshots of the internal state of the architecture and
relevant event timestamps" (§3).  This is the software restatement: named
monotonic counters, a bounded snapshot FIFO of (timestamp, event, payload)
records, and context-manager timers.  Used by the serving engine, the train
loop, and every benchmark.

Counters are open-vocabulary (any name auto-registers at zero).  The radix
prefix layer adds the reuse accounting the prefix bench gates on:
``prefix_hits`` (admissions that COW-mapped a matched prefix),
``pages_reused`` (physical frames re-shared by refcount — radix hits plus
shared-page restores), ``prefill_tokens_skipped`` (prompt tokens whose
prefill was replaced by page sharing), ``shared_restores`` (restores that
re-shared still-resident pinned-prefix frames instead of allocating), and
the router's ``prefix_routed`` (placements where the longest-matching-
prefix score changed the prefix-blind choice).

Quantized-KV serving adds ``quant_dispatches``: compute steps whose KV
pools were stored quantized (``ServeConfig.kv_dtype="int8"``), counted
alongside ``kernel_dispatches`` / ``ref_path_dispatches`` so a quantized
engine that silently lost the kernel path is visible as
``quant_dispatches > 0`` with ``ref_path_dispatches > 0``.  The accuracy
envelope that makes the quantized counters trustworthy is NOT a counter —
it is measured per run by ``benchmarks/bench_kv_quant.py`` and recorded
in the ``section:"quant"`` trajectory (``top1_agreement``: positionwise
greedy-token agreement vs the fp-pool engine; ``logit_max_abs_err``: a
model-level decode-logit probe), where ``scripts/bench_regress.py`` gates
it (agreement "ge", bytes-per-page "le" — never tok/s).

AOT-bucketed serving (``ServeConfig.aot_buckets``) adds the compile-stall
observability the open-loop SLO gate runs on: ``aot_hits`` (prefill /
continuation batches dispatched through an executable compiled at engine
build), ``aot_misses`` (batches that fell back to the shape-keyed jit —
the gate requires 0 after warmup, because each miss is a potential
first-hit compile stall on the serving path), and ``bucket_pad_tokens``
(pure padding overhead of rounding batches up to the compiled shape —
gated per prefill token, "le").  The async stream pipeline adds
``detok_backlog_peak``: the deepest the background detokenize queue ever
got — a PEAK, not a monotonic count, written directly by the
detokenizer — the observable for "host post-processing is falling behind
the device".

Portable swap records add the migration/partial-restore accounting the
``section:"migrate"`` benchmark gates on.  Scheduler-side:
``swap_exports`` / ``swap_imports`` (swap records detached from / adopted
into a replica — every completed migration is one export/import pair,
every rollback adds one more import at the source), ``partial_restores``
(capacity-blocked FIFO heads brought back as the longest page-aligned
prefix that fit, tail re-enqueued for re-prefill), ``pages_refilled``
(frames re-faulted for those evicted tails at resume admission — the
price of restoring early, paid in recompute instead of waiting), and
``second_chance_restores`` (victims behind a ``RestoreFailure``-pinned
head restored by the bounded scan without popping the head).
Router-side: ``restore_migrations`` (swapped victims moved to a replica
with headroom — rescue or starvation), ``migration_aborts``
(destination-rejected imports rolled back at the source head), and
``reach_redirects`` (placements where the admission reach filter
overrode a reach-blind policy choice).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One FIFO record: a timestamped event with an arbitrary payload."""

    t: float
    event: str
    payload: Any = None


class PerfCounters:
    """Named counters + bounded snapshot FIFO + wall-clock timers."""

    def __init__(self, fifo_depth: int = 4096):
        self.counters: collections.Counter[str] = collections.Counter()
        self.fifo: collections.deque[Snapshot] = collections.deque(maxlen=fifo_depth)
        self._timers: collections.defaultdict[str, float] = collections.defaultdict(float)
        self._t0 = time.perf_counter()

    # ---- counters ----------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def get(self, name: str) -> int:
        return self.counters[name]

    @staticmethod
    def merged(parts: "Iterator[PerfCounters] | Any") -> collections.Counter:
        """Element-wise sum of several counter sets (cross-replica
        accounting: the router's global view must equal the sum of the
        per-replica views — ``merged`` is how the global side of that
        invariant is computed, and the test suite asserts the equality
        counter by counter)."""
        total: collections.Counter[str] = collections.Counter()
        for p in parts:
            total.update(p.counters)
        return total

    def ratio(self, num: str, den: str) -> float:
        """``counters[num] / counters[den]`` (0.0 when the denominator is 0).

        The serving gate reads ``ratio("host_syncs", "decode_tokens")`` —
        host interventions per decoded token, the amortization the fused
        decode horizon exists to buy (< 1.0 means the scalar/OS plane
        stayed off the per-token critical path).
        """
        d = self.counters[den]
        return self.counters[num] / d if d else 0.0

    # ---- snapshots -----------------------------------------------------------

    def snapshot(self, event: str, payload: Any = None) -> None:
        self.fifo.append(Snapshot(time.perf_counter() - self._t0, event, payload))

    def events(self, event: str | None = None) -> list[Snapshot]:
        if event is None:
            return list(self.fifo)
        return [s for s in self.fifo if s.event == event]

    # ---- timers ------------------------------------------------------------

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            self._timers[name] += time.perf_counter() - t

    def seconds(self, name: str) -> float:
        return self._timers[name]

    # ---- reporting -----------------------------------------------------------

    def report(self) -> dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "timers_s": dict(self._timers),
            "events": len(self.fifo),
        }
