"""The serve cells: a loop of requests over the port's ``Engine.submit`` /
``Engine.step`` (the open loop here; a traffic kind's module names the
loop it runs), the window's records, and the check of what the timed
path served against the plain reference.

Each ``Engine.step()`` runs inside a span of the harness's own; the step
is classified by what it did (a prefill or continuation, else decode) and
its work is taken from the requests' own lengths: the chunks admitted and
the positions decoded.  Counters are read as deltas over the window.
Latencies come from the harness's own clock: a request's first and last
token are stamped when the ``Engine.step()`` that committed them
returns, never from the program's fields."""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench.lib import check, program, spec, weights
from portbench.lib import lengths as Ln
from portbench.lib.stats import percentile
from portbench.lib.trace import DeviceSlice

#: counters read around every step
STEP_COUNTERS = ("prefill_tokens", "continuation_prefill_tokens",
                 "decode_tokens", "failed_unreachable")


class Recorder:
    """Drives the engine one step at a time and records what each step
    did, from the requests' lengths before and after it."""

    def __init__(self, eng):
        self.eng = eng
        self.reqs: dict[int, object] = {}        # rid -> internal Request
        self.committed = 0                       # tokens committed so far
        self.steps: list[dict] = []              # recorded while on
        self.spans: list[tuple] = []             # (label, t0, t1)
        self.on = False
        self.finished: list[int] = []            # retired in the last step
        self.last: dict[int, int] = {}           # rid -> outputs seen
        self.waiting: set[int] = set()           # submitted, not yet seen
        #: rid -> (rows, longest chunk) of the prefill call that admitted it
        self.admission: dict[int, tuple[int, int]] = {}
        #: rid -> return time of the step that committed its first / its
        #: latest output token
        self.t_first: dict[int, float] = {}
        self.t_last: dict[int, float] = {}

    def submit(self, prompt, max_new: int) -> int:
        rid = self.eng.submit(program.request(prompt, max_new))
        self.reqs[rid] = self.eng.queue[-1]
        self.waiting.add(rid)
        return rid

    def step(self) -> dict:
        eng = self.eng
        before = list(eng.running)
        c = eng.counters.counters
        c0 = [c[k] for k in STEP_COUNTERS]
        t0 = time.perf_counter()
        eng.step()
        t1 = time.perf_counter()
        chunks, per_req, admitted = [], [], []
        self.finished = []
        left = [rid for rid in before if rid not in eng.running]
        # a request admitted and retired within this one step never shows
        # in ``running``; one that failed while waiting was never admitted
        self.waiting.difference_update(eng.running)
        quick = [rid for rid in self.waiting
                 if self.reqs[rid].status == "done"]
        self.waiting = {rid for rid in self.waiting
                        if self.reqs[rid].status not in ("done", "failed")}
        for rid, r in list(eng.running.items()) + [
                (rid, self.reqs[rid]) for rid in left + quick]:
            n0, n1 = self.last.get(rid), len(r.output)
            if n0 is None:                      # admitted in this step
                n0 = 0
                chunks.append((r.prefix_len, len(r.prompt)))
                admitted.append(rid)
            self.last[rid] = n1
            self.committed += n1 - n0
            if n1 > n0:
                self.t_first.setdefault(rid, t1)
                self.t_last[rid] = t1
            full = r.prefix_len + len(r.prompt)
            first = max(n0, 1)
            if n1 > first:
                per_req.append([full + j for j in range(first, n1)])
            if r.status in ("done", "failed"):
                self.finished.append(rid)
                del self.last[rid]
        for cold in (True, False):
            call = [(rid, n) for rid, (st, n) in zip(admitted, chunks)
                    if (st == 0) == cold]
            for rid, _ in call:
                self.admission[rid] = (len(call), max(n for _, n in call))
        d = [c[k] - v for k, v in zip(STEP_COUNTERS, c0)]
        kind = ("prefill" if chunks or d[0] or d[1]
                else "decode" if d[2] else "idle")
        rec = dict(t0=t0, t1=t1, kind=kind, chunks=chunks,
                   decode=[x for xs in per_req for x in xs],
                   lanes=[sum(len(xs) > t for xs in per_req)
                          for t in range(max(map(len, per_req), default=0))],
                   failed=d[3])
        if self.on:
            self.steps.append(rec)
        self.spans.append((f"host: {kind} step", t0, t1))
        return rec


def _largest_prompt(mix: dict) -> int:
    pre = mix.get("prefixes")
    return mix["prompt"]["max"] + (pre["max"] if pre else 0)


def build(ctx) -> tuple:
    """Weights, model, pool sizing and the engine; returns ``(engine,
    params, model, pool_info)``."""
    conf, dims, mix, dev = ctx.conf, ctx.dims, ctx.mix, ctx.device
    serve, pool = conf["serve"], conf["pool"]
    params = weights.make(dims, ctx.seed, dev)
    model = program.build_model(conf, dims, dev)
    page = serve["page_size"]
    longest = _largest_prompt(mix)
    frame = (2 * dims["layers"] * page * dims["kv_heads"] * dims["head_dim"]
             * torch.finfo(torch.bfloat16).bits // 8)
    if ctx.frames is None:
        torch.cuda.reset_peak_memory_stats()
        program.warm_prefill(model, params, pool["warm_rows"], longest, page)
        peak = torch.cuda.max_memory_allocated()
        total = torch.cuda.get_device_properties(dev).total_memory
        frames = int((pool["memory_fraction"] * total - peak) // frame)
    else:
        peak, total, frames = 0, 0, ctx.frames
    max_pages = -(-(longest + mix["output"]["max"]) // page) + 1
    eng = program.engine(model, params, serve, frames, max_pages,
                         kv_dtype=ctx.kv_dtype)
    return eng, params, model, dict(frames=frames, frame_bytes=frame,
                                    peak_before_pool=peak, total=total,
                                    max_pages=max_pages)


def warm(rec: Recorder, waves) -> None:
    """The warm-up: the first wave, one step, the second wave, then run
    until everything is done."""
    for r in waves[0]:
        rec.submit(r["prompt"], r["max_new"])
    rec.step()
    for r in waves[1]:
        rec.submit(r["prompt"], r["max_new"])
    while rec.eng.scheduler.has_work:
        rec.step()


def _sleep_until(t: float) -> None:
    dt = t - time.perf_counter()
    if dt > 0.002:
        time.sleep(dt - 0.001)
    while time.perf_counter() < t:
        pass


def run(ctx, loop) -> dict:
    """One run of a serve cell driven by ``loop(ctx, sched, rec)`` (its
    traffic kind's); returns the result's parts."""
    gen = spec.module("traffic", ctx.mix["kind"])
    sched = gen.schedule(ctx.mix, ctx.dims["vocab"], ctx.seed, ctx.seconds)
    eng, params, model, pool = build(ctx)
    rec = Recorder(eng)
    warm(rec, sched["warmup"])
    if ctx.trace:
        DeviceSlice.warm()
    out = loop(ctx, sched, rec)
    out["pool"] = pool
    out["memory_peak"] = (torch.cuda.max_memory_allocated()
                          if ctx.device.type == "cuda" else 0)
    # the check runs after the window, on the program's freed state
    samples = _samples(ctx, rec, out.pop("prompts"))
    eng.close()
    del eng, rec, model
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out["check"] = check.serve(ctx, params, samples, out["failed"])
    return out


class _Window:
    """Window bookkeeping of a serve loop: counters and committed tokens
    at its open and close (step boundaries), the traced slice."""

    def __init__(self, ctx, rec: Recorder, t_open: float):
        self.ctx, self.rec = ctx, rec
        self.t_open, self.t_close = t_open, t_open + ctx.seconds
        self.opened = self.closed = False
        mid = ctx.mix["trace_slice_s"]
        self.slice = DeviceSlice() if ctx.trace else None
        self.s_start = t_open + (ctx.seconds - mid) / 2
        self.s_stop = self.s_start + mid
        self.trace_steps = None

    def tick(self, now: float) -> None:
        rec = self.rec
        if not self.opened and now >= self.t_open:
            self.opened, rec.on = True, True
            self.a = (now, rec.committed, dict(rec.eng.counters.counters))
        if self.slice is not None and self.slice.h0 is None \
                and now >= self.s_start:
            self.n_before_slice = len(rec.steps)
            self.n_spans = len(rec.spans)
            self.slice.start()
        if self.slice is not None and self.slice.h0 is not None \
                and self.slice.h1 is None and now >= self.s_stop:
            self.slice.stop()
            self.trace_steps = rec.steps[self.n_before_slice:]
            self.trace_spans = rec.spans[self.n_spans:]
        if not self.closed and now >= self.t_close and now > self.a[0]:
            # a window that opened at this boundary closes at the next
            self.closed, rec.on = True, False
            self.b = (now, rec.committed, dict(rec.eng.counters.counters))
            self.queued = len(rec.eng.queue)

    def record(self) -> dict:
        (ta, ca, cnt_a), (tb, cb, cnt_b) = self.a, self.b
        counters = {k: cnt_b.get(k, 0) - cnt_a.get(k, 0)
                    for k in set(cnt_a) | set(cnt_b)}
        r = dict(window_s=tb - ta, committed=cb - ca, counters=counters,
                 steps=self.rec.steps, dims=self.ctx.dims, trace=None)
        if self.slice is not None:
            if self.trace_steps is None:
                raise RuntimeError("the traced slice never closed")
            r.update(trace=self.slice, trace_steps=self.trace_steps,
                     trace_spans=self.trace_spans)
        return r


def open_loop(ctx, sched, rec: Recorder) -> dict:
    """Submit each request at its due time whatever the engine does, step
    while there is work, and after the window drain the requests due in
    it; TTFT from each request's due time."""
    reqs = sched["requests"]
    n = len(reqs)
    t0 = time.perf_counter()
    due = [t0 + r["due"] for r in reqs]
    win = _Window(ctx, rec, t0 + sched["lead_in"])
    in_win = [i for i in range(n) if win.t_open <= due[i] < win.t_close]
    rid_of, late = {}, []
    pending = set()
    i = 0
    while True:
        now = time.perf_counter()
        win.tick(now)
        while i < n and due[i] <= now and due[i] < win.t_close:
            rid_of[i] = rec.submit(reqs[i]["prompt"], reqs[i]["max_new"])
            late.append(now - due[i])
            if win.t_open <= due[i]:
                pending.add(rid_of[i])
            i += 1
        if rec.eng.scheduler.has_work:
            st = rec.step()
            pending.difference_update(rec.finished)
            if st["failed"]:
                pending = {r for r in pending
                           if rec.reqs[r].status not in ("done", "failed")}
        elif win.closed:
            break
        else:
            nxt = min((x for x in (due[i] if i < n else math.inf,
                                  win.t_open, win.t_close,
                                  win.s_start if win.slice else math.inf,
                                  win.s_stop if win.slice else math.inf)
                       if x > now), default=now + 1e-3)
            rec.spans.append(("host: waiting for arrivals", now, nxt))
            _sleep_until(nxt)
        if win.closed and (i >= n or due[i] >= win.t_close) and (
                not pending or now > win.t_close + sched["drain"]):
            break
    ttft, tpot, failed = [], [], 0
    for k in in_win:
        rid = rid_of.get(k, -1)
        r = rec.reqs.get(rid)
        if r is None or r.status != "done" or rid not in rec.t_first:
            failed += 1
            ttft.append(math.inf)
            tpot.append(math.inf)
            continue
        ttft.append(rec.t_first[rid] - due[k])
        tpot.append((rec.t_last[rid] - rec.t_first[rid])
                    / max(len(r.output) - 1, 1))
    record = win.record()
    half = len(ttft) // 2
    e2e = dict(ttft_p95_ms=1e3 * percentile(ttft, 95),
               tpot_p95_ms=1e3 * percentile(tpot, 95))
    return dict(record=record, e2e=e2e, attempted=len(in_win), failed=failed,
                t_window_open=win.t_open,
                prompts={rid_of[k]: reqs[k]["prompt"] for k in rid_of},
                notes=dict(late_p95_ms=1e3 * percentile(late, 95),
                           late_max_ms=1e3 * max(late, default=0.0),
                           requests=n, sent=i, queued_at_close=win.queued,
                           ttft_p50_ms_halves=(
                               1e3 * percentile(ttft[:half], 50),
                               1e3 * percentile(ttft[half:], 50))))


def _samples(ctx, rec: Recorder, prompts: dict) -> list:
    """The requests the check compares: drawn from the seed among those
    finished, the one with the most served tokens always in, until
    ``check.tokens`` served tokens are in."""
    done = sorted(rid for rid, r in rec.reqs.items()
                  if r.status == "done" and rid in prompts)
    if not done:
        return []
    want, least = ctx.mix["check"]["tokens"], ctx.mix["check"]["requests"]
    longest = max(done, key=lambda r: len(rec.reqs[r].output))
    order = [longest] + [int(r) for r in Ln.rng(ctx.seed, 7).permutation(
        [r for r in done if r != longest])]
    out, total = [], 0
    for rid in order:
        toks = np.asarray([int(t) for t in rec.reqs[rid].output], np.int64)
        out.append((np.asarray(prompts[rid], np.int64), toks,
                    rec.admission.get(rid)))
        total += len(toks)
        if total >= want and len(out) >= least:
            break
    return out
