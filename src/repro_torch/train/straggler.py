"""Straggler detection for the fleet-level heartbeat (port of
``src/repro/train/straggler.py``, pure Python).

On 1000+ hosts, a single slow worker gates every synchronous step.  The
trainer emits (step, seconds) heartbeats; this monitor keeps a robust EWMA
of step time and flags outliers.  On a real cluster the launcher wires
``on_straggler`` to its remediation path (drain + reschedule the worker,
or shrink the mesh via the elastic checkpoint-reshard path); here it feeds
the perf counters and the tests assert the detection semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    ewma: float
    ratio: float


class StragglerMonitor:
    """EWMA-based step-time outlier detector (the heartbeat consumer)."""

    def __init__(
        self,
        threshold: float = 3.0,
        alpha: float = 0.1,
        warmup_steps: int = 5,
        on_straggler: Callable[[StragglerEvent], None] | None = None,
    ):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup_steps = warmup_steps
        self.on_straggler = on_straggler
        self.ewma: float | None = None
        self.events: list[StragglerEvent] = []
        self._n = 0

    def heartbeat(self, step: int, seconds: float) -> bool:
        """Feed one (step, seconds); returns True if flagged as straggler.

        The EWMA only absorbs non-flagged steps, so a persistent slowdown
        keeps firing instead of being normalized away.
        """
        self._n += 1
        if self.ewma is None:
            self.ewma = seconds
            return False
        is_straggler = (
            self._n > self.warmup_steps
            and seconds > self.threshold * self.ewma
        )
        if is_straggler:
            ev = StragglerEvent(
                step=step, seconds=seconds, ewma=self.ewma,
                ratio=seconds / self.ewma,
            )
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return is_straggler
