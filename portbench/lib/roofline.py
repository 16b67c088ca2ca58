"""Kernel rooflines and shares of peak from the run's record.

A kernel family's roofline share is the least time its calls could take
(``peaks.bound_s`` of the work its ``work/<family>.py`` counts over the
traced steps of the kinds it names) over the device time its kernels took
in those steps: traced durations, nothing subtracted, so it cannot read
negative, and it reads above 100 % only if the work is overcounted or
time is missed."""

from __future__ import annotations

from portbench.lib import peaks, spec


def kernel_pct(rec: dict, family: str) -> float | None:
    if rec.get("trace") is None:
        return None
    w = spec.module("work", family)
    steps = [s for s in rec["trace_steps"] if s["kind"] in w.STEPS]
    if not steps:
        return None
    flops, nbytes = w.work(rec["dims"], steps)
    if not flops and not nbytes:
        return None
    t = rec["trace"].family_s(w.KERNELS, [(s["t0"], s["t1"]) for s in steps])
    if not t:
        return None
    return 100.0 * peaks.bound_s(flops, nbytes) / t


def mfu_pct(rec: dict, kinds) -> float | None:
    """Model FLOPs of the window's steps of ``kinds`` over their summed
    host wall times the bf16 peak, in %."""
    tr = spec.module("work", "transformer")
    steps = [s for s in rec["steps"] if s["kind"] in kinds]
    if not steps:
        return None
    flops = sum(tr.step(rec["dims"], s) for s in steps)
    t = sum(s["t1"] - s["t0"] for s in steps)
    if not flops or t <= 0:
        return None
    return 100.0 * flops / (t * peaks.BF16_FLOPS)


def idle_pct(rec: dict) -> float | None:
    tr = rec.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def ratio(rec: dict, num: str, den: str) -> float | None:
    d = rec["counters"].get(den, 0)
    return rec["counters"].get(num, 0) / d if d else None
