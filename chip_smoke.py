#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves on the card.

    python3 chip_smoke.py            # one CUDA card, ~1.5 minutes
    python3 chip_smoke.py --quick    # build and the reduced checks only

Imports nothing of JAX and nothing of the JAX package (``src/repro``); it
puts ``src`` on ``sys.path`` and drives ``repro_torch``.  Phases, each
printing its lines; any failure exits non-zero before the last line:

1. probe: the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions, the TF32 switches (both set off: the f32 checks are f32);
2. build: every CUDA kernel of the serve path from ``src/repro_torch/
   kernels/csrc`` (one nvcc per source, in parallel), with its time;
3. reduced check: each kernel against its plain PyTorch version on the
   card at the reduced qwen2-7b shapes in f32 (D=14, G=2), with ragged
   lengths, -1 table entries, an empty sequence, a window, unaligned and
   page-aligned chunk starts, a 1-token chunk, tokens past the table and
   int8 pools; both WKV kernels in f32 at N = 16 and 64, T = 1, 27, 64
   and 96, with and without an initial state, a state handed over between
   two calls, a decay of 1e-6; then the reduced engine on the card against
   the same engine on the CPU: the cold workload, the default-policy
   workload (radix prefix hits and partial restores) and a fork workload,
   with identical greedy tokens and counters; and the reduced rwkv6-7b
   (prefill + 16 greedy decode steps, both ``tm_impl``s, 32- and 27-token
   prompts) on the card against the CPU: identical tokens, logits within
   1e-4;
4. serve: qwen2-7b at full width (bf16, random weights from a seeded
   generator) serves 8 requests (64-512-token prompts, 32 new tokens,
   page 16, horizon 8) cold, in a pool tight enough to preempt; launch
   counts are zeroed just before and read just after, and every kernel of
   the cold path must have launched; then a short int8-pool run, and a
   short workload that must give the same greedy tokens at horizon 8 and 1;
5. continuation serve: the default policy (radix prefix cache, partial
   restore) at full width — a radix run (8 prompts sharing 0, 128 or 256
   tokens of one base) in a 64-frame pool that preempts and restores
   partially, a fork run (8 ``share_prefix`` requests on a preloaded
   200-token prompt) and a short int8 radix run; each zeroes the launch
   counts before and reads them after, and both continuation kernels must
   have launched in each;
6. full-width check and timing: each kernel against its plain version on
   the largest inputs an untimed repeat of the serve runs gave it (bf16,
   within four bf16 steps of the largest output; copies bit-identical),
   then the device time of kernel, plain version and one PyTorch library
   call that computes the same function (a yardstick the port never
   calls), from CUDA events around 50 back-to-back calls with a cold L2,
   beside the least time the card could take (bytes / 3.35 TB/s or
   operations / 989 TFLOP/s bf16);
7. RWKV-6 serve: the qwen2-7b weights are freed, rwkv6-7b at full width
   (32 layers, d_model 4096, 64 heads of 64, bf16, random weights, depth
   not cut) prefills 8 prompts of 512 tokens and decodes 32 greedy tokens,
   once with ``tm_impl="sequential"`` (``wkv6`` everywhere) and once with
   ``"chunked_matmul"`` (``wkv6_chunked`` for the prefill); launch counts
   are zeroed before and read after each run; then the state is wound to
   524,284 tokens and 4 more steps must leave its bytes unchanged;
8. WKV full-width check and timing: each WKV kernel against its plain
   version (f32, within 1e-3 of the largest output) on the largest inputs
   an untimed repeat gave it (prefill, decode at T = 1, chunked prefill),
   timed as in 6, beside bytes / 3.35 TB/s or f32 operations / 67 TFLOP/s
   (the CUDA-core peak: the kernels compute in f32); then a traced,
   untimed repeat of each run's prefill and of 8 decode steps prints the
   device's busy share and device time by kernel;
9. the paper's VM loop (after the reduced checks above, which also hold
   ``paged_gather`` bit-identical to its plain version over f32/bf16/int8,
   W 4/14/512, page 8/16, any order with repeats, -1 entries, positions
   past the reach and N = 1, and ``matmul`` within 1e-4 of the largest
   output, four bf16 steps for a bf16 output, on the JAX kernel tests'
   shapes and the paper's n = 45/90/181): the quickstart
   (``repro_torch.launch.quickstart``) on the card and on the CPU must
   print the same lines, with ``paged_copy`` 1 and ``paged_gather`` 1
   launches; then one layer of qwen2-7b's K pool (W = 512, bf16, page 16,
   2,304 frames) holds a 32,768-token sequence in scrambled frames, and
   four streams (unit stride, stride 4, random with repeats, sorted
   random) are gathered bit-identical through the kernel, the plain
   version and the coalesced route, with each stream's translation counts
   and 16-entry DTLB report (host numpy); the random stream is timed;
10. the paper's matmul: n = 45, 90, 181 in f32 and qwen2-7b's gate
   projection for a 2,048-token prefill (bf16 [2048, 3584] @ [3584,
   18944] -> bf16) through ``ops.matmul`` with the launch counts zeroed
   before and read after, each against its plain version, then the
   largest and the n = 181 product timed beside ``torch.matmul``;
11. the kernel JSON line, then the device JSON line, last.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "paged_copy": ("src/repro_torch/kernels/csrc/paged_copy.cu",
                   "src/repro/kernels/paged_copy.py:27"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:30"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:39"),
    "paged_copy_at": ("src/repro_torch/kernels/csrc/paged_copy.cu",
                      "src/repro/kernels/paged_copy.py:101"),
    "paged_prefill_attention": (
        "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention.py:61"),
    "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
             "src/repro/kernels/wkv6.py:61"),
    "wkv6_chunked": ("src/repro_torch/kernels/csrc/wkv6_chunked.cu",
                     "src/repro/kernels/wkv6_chunked.py:84"),
    "paged_gather": ("src/repro_torch/kernels/csrc/paged_gather.cu",
                     "src/repro/kernels/paged_gather.py:35"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:49"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


#: bytes written between timed calls: more than the H100's 50 MB L2, so each
#: call finds its inputs in HBM, as the bound assumes
FLUSH_BYTES = 128 << 20


@functools.lru_cache(maxsize=None)
def _flush_buffer():
    import torch
    return torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def _batch_ms(fn, n: int) -> float:
    """Device milliseconds of ``n`` back-to-back calls of ``fn``.  A sleep
    kernel holds the stream while the host enqueues them, so the events
    bracket device work only (unless ``fn`` itself synchronizes)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_ms + 1) * _sleep_cycles_per_ms()))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Device time of one call of ``fn`` with a cold L2: CUDA events around
    ``n`` back-to-back calls, each after a 128 MB write that evicts the L2,
    less the same writes alone; median over ``reps`` batches."""
    flush = _flush_buffer()

    def flushed():
        flush.zero_()
        fn()

    def flush_only():
        flush.zero_()

    both = statistics.median(_batch_ms(flushed, n) for _ in range(reps))
    alone = statistics.median(_batch_ms(flush_only, n) for _ in range(reps))
    return (both - alone) / n


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def bf16_check(tag, got, want) -> tuple[float, float]:
    """``(max|got - want|, max|want|)``; fails beyond four bf16 steps of
    the largest output."""
    err, peak = max_err(got, want), float(want.float().abs().max())
    require(err <= 4 * 2**-8 * peak,
            f"{tag} err {err} > 4 * 2^-8 * max|want| ({peak}) at serve shapes")
    return err, peak


class Recorder:
    """Wraps an ``ops`` function; keeps a clone of the inputs of the call
    with the most work, so the kernel checks and timings run at the shapes
    the serve path gave it.  ``keep`` returns extra context stored with
    the best call (the continuation attention keeps the chunk lengths its
    layer's ``paged_copy_at`` was given)."""

    def __init__(self, fn, work, keep=None):
        self.fn, self.work, self.keep = fn, work, keep
        self.best, self.best_work, self.extra = None, -1, None

    def __call__(self, *args, **kw):
        w = self.work(*args, **kw)
        if w > self.best_work:
            self.best_work = w
            self.best = ([a.clone() if hasattr(a, "clone") else a
                          for a in args], dict(kw))
            self.extra = self.keep() if self.keep is not None else None
        return self.fn(*args, **kw)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def probe() -> str:
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"probe: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}, allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    return card


def build() -> None:
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    B.build_all()
    for name in B.SOURCES:
        B.load(name)
    log(f"build: {len(B.SOURCES)} kernels in {time.perf_counter() - t0:.1f}s "
        f"into {B.build_dir()}")
    for name, text in B.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def paged_inputs(gen, dev, *, b, hkv, g, d, page, n_frames, max_pages, lens,
                 dtype, quant=False):
    """Random paged-decode operands: distinct frames per row, -1 past the
    sequence's pages."""
    import torch
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev).to(dtype)
    shape = (n_frames, page, hkv, d)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_frames, generator=gen, device=dev)
    table = torch.full((b, max_pages), -1, dtype=torch.int32, device=dev)
    for i, n in enumerate(lens):
        np_ = -(-n // page)
        table[i, :np_] = perm[i * max_pages: i * max_pages + np_].int()
    return q, kp, vp, table, torch.tensor(lens, dtype=torch.int32, device=dev)


def prefill_inputs(gen, dev, *, hkv, g, d, page, n_frames, max_pages, starts,
                   chunks, dtype, quant=False):
    """Random continuation-attention operands: q as the strided view of a
    projection, shuffled frames covering each row's ``start + chunk``
    tokens, -1 beyond."""
    import torch
    b, s = len(starts), max(chunks)
    q = torch.randn((b, s, hkv * g * d), generator=gen,
                    device=dev).to(dtype).view(b, s, hkv, g, d)
    shape = (n_frames, page, hkv, d)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_frames, generator=gen, device=dev).int()
    table = torch.full((b, max_pages), -1, dtype=torch.int32, device=dev)
    for i, (st, c) in enumerate(zip(starts, chunks)):
        n = -(-(st + c) // page)
        table[i, :n] = perm[i * max_pages: i * max_pages + n]
    return (q, kp, vp, table,
            torch.tensor(starts, dtype=torch.int32, device=dev), chunks)


def reduced_checks() -> None:
    """Each kernel vs its plain version at the reduced f32 shapes.  f32
    tolerance 1e-5: both sides accumulate in f32, only the summation order
    differs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_copy import paged_copy, paged_copy_at
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention,
    )
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = 1e-5
    # paged_copy: partial tail page, unmapped trailing bursts, int8 and f32
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        b, s, w, page, frames, maxp = 3, 20, 28, 4, 24, 6
        if dtype == torch.int8:
            src = torch.randint(-127, 128, (b, s, w), generator=gen,
                                device=dev, dtype=torch.int32).to(dtype)
        else:
            src = torch.randn((b, s, w), generator=gen, device=dev).to(dtype)
        pool = torch.zeros((frames, page, w), dtype=dtype, device=dev)
        perm = torch.randperm(frames - 1, generator=gen, device=dev).int()
        lens = torch.tensor([20, 13, 0], dtype=torch.int32, device=dev)
        table = torch.full((b, maxp), -1, dtype=torch.int32, device=dev)
        table[0, :5] = perm[:5]
        table[1, :4] = perm[5:9]        # 13 tokens: partial tail page
        got = paged_copy(src, pool.clone(), table, lens, page_size=page)
        want = ref.paged_copy_ref(src, pool.clone(), table, lens,
                                  page_size=page)
        require(torch.equal(got, want), f"paged_copy {dtype} differs")
    log("check reduced: paged_copy f32/bf16/int8 bit-identical")
    # flash attention: S not a multiple of the tile, G = 2, D = 14
    for s in (20, 100, 131):
        q = torch.randn((2, 4, s, 14), generator=gen, device=dev)
        k = torch.randn((2, 2, s, 14), generator=gen, device=dev)
        v = torch.randn((2, 2, s, 14), generator=gen, device=dev)
        err = max_err(flash_attention(q, k, v),
                      ref.flash_attention_ref(q, k, v))
        require(err <= tol, f"flash_attention S={s} f32 err {err}")
    log(f"check reduced: flash_attention f32 S in (20,100,131) within {tol}")
    # paged decode: -1 entries, empty sequence, window, int8 pools
    for quant in (False, True):
        for window in (None, 5):
            q, kp, vp, table, lens = paged_inputs(
                gen, dev, b=4, hkv=2, g=2, d=14, page=4, n_frames=40,
                max_pages=8, lens=[13, 0, 32, 1], dtype=torch.float32,
                quant=quant)
            kvs = 1 / 24 if quant else None
            got = paged_decode_attention(q, kp, vp, table, lens, page_size=4,
                                         window=window, kv_scale=kvs)
            want = ref.paged_decode_attention_ref(
                q, kp, vp, table, lens, page_size=4, window=window,
                kv_scale=kvs)
            err = max_err(got, want)
            require(err <= tol, f"paged_decode_attention quant={quant} "
                                f"window={window} err {err}")
            require(float(got[1].abs().max()) == 0.0, "empty sequence != 0")
    log(f"check reduced: paged_decode_attention f32/int8, window, len 0 "
        f"within {tol}")
    # paged_copy_at: unaligned start ending mid-page (both edge pages), an
    # aligned start, a 1-token chunk, a padded row across an unmapped page,
    # a row past the table; the whole pool must be bit-identical
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        b, s, w, page, frames, maxp = 5, 9, 28, 4, 40, 6
        src = torch.randn((b, s, w), generator=gen, device=dev).mul(50)
        pool = torch.randn((frames, page, w), generator=gen, device=dev)
        src, pool = src.to(dtype), pool.mul(50).to(dtype)
        table = torch.randperm(frames, generator=gen, device=dev).int()[
            : b * maxp].view(b, maxp).contiguous()
        table[3, 2] = -1
        starts = torch.tensor([2, 8, 5, 7, 21], dtype=torch.int32, device=dev)
        lens = torch.tensor([9, 7, 1, 4, 6], dtype=torch.int32, device=dev)
        got = paged_copy_at(src, pool.clone(), table, starts, lens,
                            page_size=page)
        want = ref.paged_copy_at_ref(src, pool.clone(), table, starts, lens,
                                     page_size=page)
        require(torch.equal(got, want), f"paged_copy_at {dtype} differs")
    log("check reduced: paged_copy_at f32/bf16/int8 bit-identical on the "
        "whole pool")
    # paged_prefill_attention: mid-page, aligned and zero starts, chunks of
    # 13, 1 and 8 (padded to 13), -1 past each row's pages, int8 pools
    for quant in (False, True):
        q, kp, vp, table, starts, chunks = prefill_inputs(
            gen, dev, hkv=2, g=2, d=14, page=4, n_frames=48, max_pages=10,
            starts=[5, 8, 0], chunks=[13, 1, 8], dtype=torch.float32,
            quant=quant)
        kvs = 1 / 24 if quant else None
        got = paged_prefill_attention(q, kp, vp, table, starts, page_size=4,
                                      kv_scale=kvs)
        want = ref.paged_prefill_attention_ref(q, kp, vp, table, starts,
                                               page_size=4, kv_scale=kvs)
        err = max(max_err(got[i, :c], want[i, :c])
                  for i, c in enumerate(chunks))
        require(err <= tol, f"paged_prefill_attention quant={quant} "
                            f"err {err}")
    log(f"check reduced: paged_prefill_attention f32/int8, unaligned and "
        f"aligned starts, 1-token chunk, padded rows within {tol}")
    ops.reset_launch_counts()


def close_err(got, want, tol) -> float:
    """``max(|got - want| - tol * |want|)``: at most ``tol`` when the two
    agree within ``atol = rtol = tol`` (``torch.testing.assert_close``)."""
    return float(((got.float() - want.float()).abs()
                  - tol * want.float().abs()).max())


def wkv_operands(gen, dev, bh, t, n, *, state, decay=None):
    """f32 r, k, v (scale 0.5), w = sigmoid(z - 1) or a constant decay, u,
    and an optional initial state (scale 0.1), as the CPU tests draw them."""
    import torch

    def f(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev) * sc
    r, k, v = f(bh, t, n, sc=0.5), f(bh, t, n, sc=0.5), f(bh, t, n, sc=0.5)
    w = (torch.sigmoid(f(bh, t, n) - 1.0) if decay is None
         else torch.full((bh, t, n), decay, device=dev))
    return r, k, v, w, f(bh, n, sc=0.5), (f(bh, n, n, sc=0.1) if state
                                          else None)


def reduced_wkv_checks() -> None:
    """Both WKV kernels against their plain versions on the card, f32, at
    the tolerances of their CPU tests against the Pallas kernels: 1e-4
    sequential, 3e-4 chunked (the chunked form takes every decay as an exp
    of a cumsum of logs), 1e-3 at a decay of 1e-6."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    kernels = (("wkv6", wkv6, ref.wkv6_ref, 1e-4),
               ("wkv6_chunked", wkv6_chunked,
                lambda *a: ref.wkv6_chunked_matmul_ref(*a, chunk=32), 3e-4))
    for name, kern, plain, tol in kernels:
        worst = 0.0
        for n in (16, 64):
            for t in (1, 27, 64, 96):
                for state in (False, True):
                    args = wkv_operands(gen, dev, 6, t, n, state=state)
                    for g_, w_ in zip(kern(*args), plain(*args)):
                        err = close_err(g_, w_, tol)
                        require(err <= tol, f"{name} N={n} T={t} "
                                            f"state={state}: off by {err}")
                        worst = max(worst, max_err(g_, w_))
        # a state handed over between two calls (written in place into
        # the caller's state) equals one call
        r, k, v, w, u, _ = wkv_operands(gen, dev, 4, 96, 64, state=False)
        o_full, s_full = kern(r, k, v, w, u)
        s = torch.zeros_like(s_full)
        o1, _ = kern(*(x[:, :64].contiguous() for x in (r, k, v, w)), u, s,
                     out_state=s)
        o2, _ = kern(*(x[:, 64:].contiguous() for x in (r, k, v, w)), u, s,
                     out_state=s)
        require(close_err(torch.cat([o1, o2], 1), o_full, 1e-4) <= 1e-4
                and close_err(s, s_full, 1e-4) <= 1e-4,
                f"{name}: a handed-over state differs from one call")
        # a decay of 1e-6: finite, and within 1e-3 of the step loop
        args = wkv_operands(gen, dev, 4, 64, 16, state=False, decay=1e-6)
        got, want = kern(*args), ref.wkv6_ref(*args)
        require(all(torch.isfinite(x).all() for x in got),
                f"{name}: not finite at a decay of 1e-6")
        require(all(close_err(g_, w_, 1e-3) <= 1e-3
                    for g_, w_ in zip(got, want)),
                f"{name}: off at a decay of 1e-6")
        torch.cuda.synchronize()
        log(f"check reduced: {name} f32 N in (16, 64), T in (1, 27, 64, 96), "
            f"with and without a state, handoff, decay 1e-6 within {tol} "
            f"(largest |err| {worst:.3g})")
    ops.reset_launch_counts()


def to_device(p, dev):
    """A params tree (dicts and lists of tensors) on ``dev``."""
    if isinstance(p, dict):
        return {k: to_device(v, dev) for k, v in p.items()}
    if isinstance(p, list):
        return [to_device(v, dev) for v in p]
    return p.to(dev)


def run_engine(model, params, serve_cfg, reqs, prefix=None):
    """Serve ``reqs`` (after preloading ``prefix``, if given) to the end;
    returns the engine, its results and the drain's wall seconds."""
    from repro_torch.serve import Engine
    eng = Engine(model, params, serve_cfg)
    if prefix is not None:
        eng.preload_prefix(prefix)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    t0 = time.perf_counter()
    res = eng.drain()
    dt = time.perf_counter() - t0
    eng.close()
    return eng, res, dt


def reduced_engine_check() -> None:
    """The reduced qwen2-7b engine on the card (kernels) against the same
    engine and weights on the CPU (plain versions): identical greedy tokens
    and counters on the mixed preemption workload."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig
    cfg = get_config("qwen2-7b", reduced=True)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(0)
    gpu_model = build_model(cfg, device="cuda")
    gpu_params = to_device(cpu_params, "cuda")
    for kv in ("native", "int8"):
        scfg = ServeConfig(page_size=4, num_pages=16, max_pages_per_seq=16,
                           max_batch=3, prefix_cache=False,
                           restore_patience=0, kv_dtype=kv)
        # the mixed-preemption workload of tests/test_serve_executor.py
        reqs = serve_workload(cfg.vocab_size, n=7, lo=4, hi=13, max_new=12,
                              seed=13)
        e_cpu, r_cpu, _ = run_engine(cpu_model, cpu_params, scfg, reqs)
        e_gpu, r_gpu, _ = run_engine(gpu_model, gpu_params, scfg, reqs)
        require(e_gpu.counters.get("preemptions") > 0, "no preemption")
        for c in ("preemptions", "restores", "completed", "host_syncs"):
            require(e_cpu.counters.get(c) == e_gpu.counters.get(c),
                    f"reduced engine counter {c} differs")
        same = all(r_cpu[i].tokens == r_gpu[i].tokens for i in r_cpu)
        require(same, f"reduced engine ({kv}) tokens differ card vs cpu")
    log("check reduced engine: card == cpu greedy tokens and counters "
        "(native and int8 pools, with preemption)")

    # the continuation path: the default policy on the shared-base workload
    # of tests/test_torch_continuation.py (radix hits, partial restores),
    # and forks of a 13-token prefix at page 8 (chunks of 1, 7, 12 in one
    # batch).  Every counter must match, except prefill_bytes_gathered,
    # which counts by route: the kernel's pages_touched on the card, the
    # plain version's full table reach on the CPU.
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(13)
    base = rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
    radix = [ServeRequest(req_id=i, max_new_tokens=12, prompt=np.concatenate(
        [base[:8], rng.integers(0, cfg.vocab_size, size=int(
            rng.integers(4, 14))).astype(np.int32)])) for i in range(7)]
    rng = np.random.default_rng(23)
    prefix = rng.integers(0, cfg.vocab_size, size=13).astype(np.int32)
    forks = [ServeRequest(req_id=i, max_new_tokens=6, share_prefix=True,
                          prompt=rng.integers(0, cfg.vocab_size, size=n)
                          .astype(np.int32)) for i, n in enumerate((1, 7, 12))]
    cases = (
        ("default policy", ServeConfig(page_size=4, num_pages=16,
                                       max_pages_per_seq=16, max_batch=3),
         radix, None),
        ("default policy int8", ServeConfig(
            page_size=4, num_pages=16, max_pages_per_seq=16, max_batch=3,
            kv_dtype="int8"), radix, None),
        ("fork", ServeConfig(page_size=8, num_pages=64, max_pages_per_seq=16,
                             max_batch=4), forks, prefix),
    )
    for tag, scfg, reqs, pre in cases:
        ops.reset_launch_counts()
        e_gpu, r_gpu, _ = run_engine(gpu_model, gpu_params, scfg, reqs, pre)
        launches = ops.launch_counts()
        e_cpu, r_cpu, _ = run_engine(cpu_model, cpu_params, scfg, reqs, pre)
        c_cpu = dict(e_cpu.counters.counters)
        c_gpu = dict(e_gpu.counters.counters)
        for c in ("prefill_bytes_gathered",):
            c_cpu.pop(c, None)
            c_gpu.pop(c, None)
        diff = {k: (c_cpu.get(k), c_gpu.get(k)) for k in set(c_cpu) | set(c_gpu)
                if c_cpu.get(k) != c_gpu.get(k)}
        require(not diff, f"reduced engine ({tag}) counters differ card vs "
                          f"cpu: {diff}")
        require(all(r_cpu[i].tokens == r_gpu[i].tokens for i in r_cpu),
                f"reduced engine ({tag}) tokens differ card vs cpu")
        require(e_gpu.stats()["switch_stats"] == e_cpu.stats()["switch_stats"],
                f"reduced engine ({tag}) switch stats differ")
        for k in ("paged_copy_at", "paged_prefill_attention"):
            require(launches[k] > 0, f"reduced engine ({tag}): {k} never "
                                     f"launched")
        if tag.startswith("default"):
            require(c_gpu.get("prefix_hits", 0) > 0
                    and c_gpu.get("partial_restores", 0) > 0,
                    f"reduced engine ({tag}): no prefix hit or no partial "
                    "restore")
        log(f"check reduced engine ({tag}): card == cpu greedy tokens and "
            f"all counters; prefix_hits {c_gpu.get('prefix_hits', 0)}, "
            f"partial_restores {c_gpu.get('partial_restores', 0)}, "
            f"forked_admissions {c_gpu.get('forked_admissions', 0)}, "
            f"prefill_bytes_gathered card "
            f"{e_gpu.counters.get('prefill_bytes_gathered')} / cpu "
            f"{e_cpu.counters.get('prefill_bytes_gathered')}")


def serve_workload(vocab: int, n: int, lo: int, hi: int, max_new: int,
                   seed: int):
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(req_id=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(lo, hi + 1))).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


#: the full-width serve phase: 8 requests, 64-512-token prompts, 32 new
#: tokens, page 16, horizon 8, a pool of 72 frames (1 scratch) for 4 lanes,
#: tight enough that the scheduler preempts
SERVE = dict(page_size=16, num_pages=72, max_pages_per_seq=36, max_batch=4,
             max_horizon=8, prefix_cache=False, restore_patience=0)
WORKLOAD = dict(n=8, lo=64, hi=512, max_new=32, seed=0)
SHORT = dict(n=4, lo=64, hi=256, max_new=16, seed=1)
#: the kernels of the cold path (the serve phase above)
COLD_KERNELS = ("paged_copy", "flash_attention", "paged_decode_attention")
#: the continuation kernels (radix hits, forks, partial restores)
CONT_KERNELS = ("paged_copy_at", "paged_prefill_attention")

#: the continuation phase: the default policy (radix prefix cache on,
#: partial restore after 6 blocked restore passes), page 16, horizon 8, 4
#: lanes.  64 frames (1 scratch): the schedule depends on lengths only, and
#: a CPU run of it with the reduced model gave no partial restore at 72
#: frames, one at 68 and three at 64
CONT = dict(page_size=16, num_pages=64, max_pages_per_seq=36, max_batch=4,
            max_horizon=8)


def radix_workload(vocab: int, n: int = 8, seed: int = 2, max_new: int = 32):
    """Prompt i is the first 0, 128 or 256 tokens (by ``i % 3``) of one
    256-token base, then a 16-256-token tail of its own."""
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=256).astype(np.int32)
    return [ServeRequest(req_id=i, max_new_tokens=max_new, prompt=np.concatenate(
        [base[: (0, 128, 256)[i % 3]], rng.integers(0, vocab, size=int(
            rng.integers(16, 257))).astype(np.int32)])) for i in range(n)]


def fork_workload(vocab: int, n: int = 8, seed: int = 3, max_new: int = 32):
    """A 200-token system prompt (12 pages + 8 tokens: every fork copies
    the tail page and starts its chunk mid-page) and ``n`` ``share_prefix``
    requests with 16-256-token prompts."""
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=200).astype(np.int32)
    return prefix, [ServeRequest(
        req_id=i, max_new_tokens=max_new, share_prefix=True,
        prompt=rng.integers(0, vocab, size=int(rng.integers(16, 257)))
        .astype(np.int32)) for i in range(n)]


def full_model():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2-7b")          # all 28 layers: depth is not cut
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    log(f"serve: qwen2-7b full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16) "
        f"initialised on the card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    return cfg, model, params


#: the continuation path's own counters, printed beside the cold ones
CONT_KEYS = ("prefix_hits", "pages_reused", "prefill_tokens_skipped",
             "partial_restores", "pages_refilled", "shared_restores",
             "forked_admissions", "fork_batches", "continuation_prefill_tokens",
             "prefill_bytes_gathered")


def report(tag, eng, res, dt, extra=()):
    c = eng.counters
    st = eng.stats()["switch_stats"]
    toks = sum(len(r.tokens) for r in res.values())
    require(toks > 0 and dt > 0, f"{tag}: no tokens")
    done = [r for r in res.values() if r.status == "done"]
    ttft = sorted(r.ttft for r in done)
    tpot = sorted(r.tpot for r in done)
    log(f"{tag}: {len(done)}/{len(res)} done, {toks} tokens in {dt:.3f}s = "
        f"{toks / dt:.1f} tok/s; TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms,"
        f" TPOT p50 {tpot[len(tpot) // 2] * 1e3:.2f} ms")
    keys = ("preemptions", "restores", "page_faults", "completed",
            "host_syncs", "decode_dispatches", "decode_horizon",
            "decode_tokens", "prefill_tokens", "ptab_syncs",
            "ptab_rows_uploaded", "kernel_dispatches",
            "ref_path_dispatches", "quant_dispatches") + tuple(extra)
    log(f"{tag} counters: " + json.dumps({k: c.get(k) for k in keys}))
    log(f"{tag} switch_stats: " + json.dumps(st))


def serve_phase(cfg, model, params):
    """Drive the main path as a user runs it; returns the launch counts of
    the full-width run and of the int8 run."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig

    scfg = ServeConfig(**SERVE)
    reqs = serve_workload(cfg.vocab_size, **WORKLOAD)
    ops.reset_launch_counts()
    eng, res, dt = run_engine(model, params, scfg, reqs)
    launches = ops.launch_counts()
    report("serve", eng, res, dt)
    log("serve launches: " + json.dumps(launches))
    c, st = eng.counters, eng.stats()["switch_stats"]
    for n in COLD_KERNELS:
        require(launches[n] > 0, f"{n} was never launched on the serve path")
    require(c.get("ref_path_dispatches") == 0, "plain-path dispatches")
    require(c.get("preemptions") > 0, "the pool never preempted")
    require(st["bytes_spilled"] == st["bytes_restored"] > 0,
            "bytes_spilled != bytes_restored")
    require(all(r.status == "done" for r in res.values()),
            "a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in res.values()
                for t in r.tokens), "token outside the vocabulary")
    require(all(len(r.tokens) == WORKLOAD["max_new"]
                for r in res.values()), "wrong number of tokens")
    del eng

    # int8 pools: the quantized decode variant on the serve path
    ops.reset_launch_counts()
    eng, res, dt = run_engine(
        model, params, dataclasses.replace(scfg, kv_dtype="int8"),
        serve_workload(cfg.vocab_size, **SHORT))
    launches_q = ops.launch_counts()
    report("serve int8", eng, res, dt)
    log("serve int8 launches: " + json.dumps(launches_q))
    require(all(r.status == "done" for r in res.values()),
            "int8 run did not finish")
    require(launches_q["paged_decode_attention"] > 0,
            "int8 decode kernel never launched")
    require(eng.counters.get("quant_dispatches") > 0, "no int8 steps")
    del eng

    # horizon transparency on a short workload at full width
    outs = {}
    for mh in (8, 1):
        eng, res, _ = run_engine(
            model, params, dataclasses.replace(scfg, max_horizon=mh),
            serve_workload(cfg.vocab_size, **SHORT))
        outs[mh] = {i: r.tokens for i, r in res.items()}
        del eng
    require(outs[8] == outs[1], "max_horizon 8 and 1 gave different tokens")
    log("serve: max_horizon=8 and max_horizon=1 give identical greedy "
        "tokens on the short workload")
    return launches, launches_q


def continuation_runs(cfg):
    """``(tag, ServeConfig, prefix, requests)`` of the continuation phase:
    radix, fork, and a short radix run on int8 pools."""
    from repro_torch.serve import ServeConfig
    scfg = ServeConfig(**CONT)
    prefix, forks = fork_workload(cfg.vocab_size)
    return (
        ("radix", scfg, None, radix_workload(cfg.vocab_size)),
        ("fork", scfg, prefix, forks),
        ("radix int8", dataclasses.replace(scfg, kv_dtype="int8"), None,
         radix_workload(cfg.vocab_size, n=4, max_new=16)),
    )


def continuation_phase(cfg, model, params) -> dict[str, dict[str, int]]:
    """Drive the continuation path as a user runs it (the default policy);
    returns each run's launch counts.  Each run is also served cold
    (prefix cache off, no partial restore, forks as whole prompts) and the
    share of requests with the same greedy tokens is printed, not
    required: the warm path attends through paged_prefill_attention, the
    cold one through flash_attention, and bf16 sums in another order can
    flip a near-tie under random weights."""
    import numpy as np
    from repro_torch.kernels import ops

    counts = {}
    for tag, scfg, prefix, reqs in continuation_runs(cfg):
        ops.reset_launch_counts()
        eng, res, dt = run_engine(model, params, scfg, reqs, prefix)
        launches = ops.launch_counts()
        counts[tag] = launches
        report(tag, eng, res, dt, CONT_KEYS)
        log(f"{tag} launches: " + json.dumps(launches))
        c = eng.counters
        require(all(r.status == "done" for r in res.values()),
                f"{tag}: a request did not finish")
        require(all(len(r.tokens) == reqs[0].max_new_tokens
                    and all(0 <= t < cfg.vocab_size for t in r.tokens)
                    for r in res.values()),
                f"{tag}: wrong number of tokens or a token outside the "
                "vocabulary")
        require(c.get("ref_path_dispatches") == 0,
                f"{tag}: plain-path dispatches")
        for n in CONT_KERNELS:
            require(launches[n] > 0, f"{tag}: {n} was never launched")
        if tag == "radix":
            require(c.get("prefix_hits") > 0, "radix: no prefix hit")
            require(c.get("partial_restores") >= 1,
                    "radix: no partial restore")
        if tag == "fork":
            require(c.get("forked_admissions") == len(reqs),
                    "fork: not every request forked")
            require(c.get("fork_batches") >= 1, "fork: no fork batch")
        if tag.endswith("int8"):
            require(c.get("quant_dispatches") > 0, "radix int8: no int8 steps")
            continue
        cold = [dataclasses.replace(
            r, share_prefix=False, prompt=r.prompt if prefix is None
            else np.concatenate([prefix, r.prompt])) for r in reqs]
        _, cres, _ = run_engine(model, params, dataclasses.replace(
            scfg, prefix_cache=False, restore_patience=0), cold)
        same = sum(res[i].tokens == cres[i].tokens for i in res)
        first = sum(res[i].tokens[0] == cres[i].tokens[0] for i in res)
        lead = [next((k for k, (a, b) in enumerate(
            zip(res[i].tokens, cres[i].tokens)) if a != b),
            len(res[i].tokens)) for i in res]
        log(f"{tag}: {same}/{len(res)} requests give the same greedy tokens "
            f"as the same workload served cold, {first}/{len(res)} the same "
            f"first token; tokens agree up to positions {lead} (printed, "
            "not required)")
        del eng
    return counts


class ChunkTap:
    """Wraps ``ops.paged_copy_at`` and remembers the chunk lengths of its
    last call: the continuation attention that follows in the same layer
    runs on those chunks."""

    def __init__(self, fn):
        self.fn, self.lens = fn, None

    def __call__(self, src, pool, pt, starts, lens, **kw):
        self.lens = lens
        return self.fn(src, pool, pt, starts, lens, **kw)


def attended_pairs(starts, chunks) -> int:
    """(query, key) pairs the continuation attention needs: query ``t`` of
    row ``b`` sees ``starts[b] + t + 1`` keys."""
    return sum(c * (s + 1) + c * (c - 1) // 2
               for s, c in zip(starts, chunks))


def record_inputs(cfg, model, params):
    """Repeat the serve runs, untimed, with each ``ops`` wrapper wrapped in
    a :class:`Recorder` (which synchronizes to weigh each call), and return
    the recorders of the full-width runs, the int8 decode recorder and the
    int8 continuation-attention recorder."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig

    def pairs(tap):
        return lambda q, kp, vp, pt, starts, **kw: attended_pairs(
            starts[:q.shape[0]].tolist(), tap.lens[:q.shape[0]].tolist())

    cold = ("paged_copy", "flash_attention", "paged_decode_attention")
    saved = {n: getattr(ops, n) for n in (*cold, *CONT_KERNELS)}
    rec = {
        "paged_copy": Recorder(
            ops.paged_copy, lambda src, pool, pt, lens, **k: int(lens.sum())),
        "flash_attention": Recorder(
            ops.flash_attention, lambda q, k, v, **kw: q.numel()),
        "paged_decode_attention": Recorder(
            ops.paged_decode_attention,
            lambda q, kp, vp, pt, sl, **kw: int(sl[:q.shape[0]].sum())),
        "paged_copy_at": Recorder(
            ops.paged_copy_at,
            lambda src, pool, pt, st, lens, **k: int(lens.sum())),
    }
    tap = ChunkTap(rec["paged_copy_at"])
    rec["paged_prefill_attention"] = Recorder(
        ops.paged_prefill_attention, pairs(tap),
        keep=lambda: tap.lens.clone())
    rec_q = Recorder(saved["paged_decode_attention"],
                     rec["paged_decode_attention"].work)
    tap_q = ChunkTap(saved["paged_copy_at"])
    rec_pq = Recorder(saved["paged_prefill_attention"], pairs(tap_q),
                      keep=lambda: tap_q.lens.clone())

    def use(**wrappers):
        """Record through ``wrappers`` only; every other op runs bare."""
        for n, f in saved.items():
            setattr(ops, n, wrappers.get(n, f))

    try:
        # each run records only the kernels of its own path, so the cold
        # rows keep the shapes of the cold serve run
        scfg = ServeConfig(**SERVE)
        use(**{n: rec[n] for n in cold})
        run_engine(model, params, scfg,
                   serve_workload(cfg.vocab_size, **WORKLOAD))
        use(paged_decode_attention=rec_q)
        run_engine(model, params, dataclasses.replace(scfg, kv_dtype="int8"),
                   serve_workload(cfg.vocab_size, **SHORT))
        runs = continuation_runs(cfg)
        use(paged_copy_at=tap,
            paged_prefill_attention=rec["paged_prefill_attention"])
        for _, ccfg, prefix, reqs in runs[:2]:
            run_engine(model, params, ccfg, reqs, prefix)
        use(paged_copy_at=tap_q, paged_prefill_attention=rec_pq)
        _, ccfg, prefix, reqs = runs[2]
        run_engine(model, params, ccfg, reqs, prefix)
    finally:
        use()
    return rec, rec_q, rec_pq


def bound(nbytes: float, flops: float):
    """Least time on the card: bytes over HBM bandwidth or bf16 operations
    over the tensor-core peak, whichever is longer (H100 SXM data sheet)."""
    from repro_torch.core.costmodel import H100_HBM_BW, H100_PEAK_FLOPS_BF16
    tb = nbytes / H100_HBM_BW * 1e3
    tf = flops / H100_PEAK_FLOPS_BF16 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def full_checks(rec, rec_q, launches, launches_q) -> list[dict]:
    """Kernel vs plain version on the recorded serve inputs, then timings.
    bf16 attention tolerance: four bf16 steps of the largest output,
    ``4 * 2**-8 * max|want|``.  Both sides take the same bf16 inputs and
    sum in f32 in different orders, and round once to bf16 (one step is
    at most ``2**-8`` relative), so a right kernel differs by about one
    step; a dropped page or head moves outputs by far more."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_copy import paged_copy
    rows = []

    # paged_copy — bit-identical
    (src, pool, pt, lens), kw = rec["paged_copy"].best
    page = kw["page_size"]
    got = paged_copy(src, pool.clone(), pt, lens, page_size=page)
    want = ref.paged_copy_ref(src, pool.clone(), pt, lens, page_size=page)
    require(torch.equal(got, want), "paged_copy differs at serve shapes")
    n_tok = int(lens.sum())
    w = src.shape[2]
    nbytes = 2 * n_tok * w * src.element_size() + pt.numel() * 4 + lens.numel() * 4
    tok = torch.arange(src.shape[1], device=src.device)
    valid = tok[None, :] < lens[:, None]
    flat_rows = (pt.long()[:, tok // page] * page + tok % page)[valid]
    flat_src = src[valid]
    work = pool.clone()
    ms = time_ms(lambda: paged_copy(src, work, pt, lens, page_size=page))
    plain = time_ms(lambda: ref.paged_copy_ref(src, work, pt, lens,
                                               page_size=page))
    lib = time_ms(lambda: work.view(-1, w).index_copy_(0, flat_rows, flat_src))
    b_ms, b_by = bound(nbytes, 0)
    rows.append(dict(name="paged_copy", shape=f"src {list(src.shape)} "
                     f"{src.dtype}, pool {list(pool.shape)}, {n_tok} tokens",
                     max_abs_err=0.0, max_abs_want=float(src.abs().max()),
                     ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib,
                     library="index_copy_ on the flat pool",
                     launches=launches["paged_copy"]))

    # flash attention
    (q, k, v), kw = rec["flash_attention"].best
    got = flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    err, peak = bf16_check("flash_attention", got, want)
    b, hq, s, d = q.shape
    flops = 4.0 * b * hq * d * s * (s + 1) / 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    lib_name = "F.scaled_dot_product_attention(is_causal, enable_gqa)"

    def lib_call():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    lib = time_ms(lib_call)
    b_ms, b_by = bound(nbytes, flops)
    rows.append(dict(name="flash_attention", shape=f"q {list(q.shape)} "
                     f"k {list(k.shape)} {q.dtype}", max_abs_err=err,
                     max_abs_want=peak, ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib, library=lib_name,
                     launches=launches["flash_attention"]))

    # paged decode attention (bf16 pools, then int8 pools)
    for tag, r, counts in (("paged_decode_attention", rec, launches),
                           ("paged_decode_attention_int8", None, launches_q)):
        (q, kp, vp, pt, sl), kw = (r["paged_decode_attention"].best
                                   if r is not None else rec_q.best)
        kw = dict(kw)
        kw.pop("use_kernel", None)
        got = paged_decode_attention(q, kp, vp, pt, sl, **kw)
        want = ref.paged_decode_attention_ref(q, kp, vp, pt, sl, **kw)
        err, peak = bf16_check(tag, got, want)
        bsz, hkv, g, d = q.shape
        n_tok = int(sl[:bsz].sum())
        flops = 4.0 * g * d * hkv * n_tok
        n_pages = int(((sl[:bsz] + kw["page_size"] - 1)
                       // kw["page_size"]).sum())
        nbytes = (2 * n_tok * hkv * d * kp.element_size()
                  + 2 * q.numel() * q.element_size() + bsz * 4 + n_pages * 4)
        ms = time_ms(lambda: paged_decode_attention(q, kp, vp, pt, sl, **kw))
        plain = time_ms(lambda: ref.paged_decode_attention_ref(
            q, kp, vp, pt, sl, **kw))
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(name=tag, shape=f"q {list(q.shape)} {q.dtype}, "
                         f"pool {list(kp.shape)} {kp.dtype}, {n_tok} cached "
                         f"tokens", max_abs_err=err, max_abs_want=peak,
                         ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         library=None,
                         launches=counts["paged_decode_attention"]))
    print_rows(rows)
    return rows


def continuation_checks(rec, rec_pq, counts) -> list[dict]:
    """The continuation kernels against their plain versions on the
    recorded inputs of the continuation runs, then their timings; the same
    tolerances as :func:`full_checks`.  The bound counts each input once:
    q, the output, and each row's key/value pages up to its last real
    query, once (the kernel fetches a page once per query block; it prints
    those bytes too)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_copy import paged_copy_at
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention,
        pages_touched,
        query_block,
    )
    rows = []
    served = {k: counts["radix"][k] + counts["fork"][k]
              for k in CONT_KERNELS}

    # paged_copy_at — bit-identical on the whole pool
    (src, pool, pt, starts, lens), kw = rec["paged_copy_at"].best
    page = kw["page_size"]
    got = paged_copy_at(src, pool.clone(), pt, starts, lens, page_size=page)
    want = ref.paged_copy_at_ref(src, pool.clone(), pt, starts, lens,
                                 page_size=page)
    require(torch.equal(got, want), "paged_copy_at differs at serve shapes")
    b, s, w = src.shape
    n_tok = int(lens[:b].sum())
    nbytes = (2 * n_tok * w * src.element_size() + pt.numel() * 4
              + 2 * b * 4)
    tok = torch.arange(s, device=src.device)
    pos = starts[:b, None].long() + tok[None, :]
    valid = tok[None, :] < lens[:b, None]
    vpn = (pos // page).clamp(max=pt.shape[1] - 1)
    flat_rows = (pt[:b].long().gather(1, vpn) * page + pos % page)[valid]
    flat_src = src[valid]
    work = pool.clone()
    ms = time_ms(lambda: paged_copy_at(src, work, pt, starts, lens,
                                       page_size=page))
    plain = time_ms(lambda: ref.paged_copy_at_ref(src, work, pt, starts, lens,
                                                  page_size=page))
    lib = time_ms(lambda: work.view(-1, w).index_copy_(0, flat_rows, flat_src))
    b_ms, b_by = bound(nbytes, 0)
    rows.append(dict(name="paged_copy_at", shape=f"src {list(src.shape)} "
                     f"{src.dtype}, pool {list(pool.shape)}, {n_tok} tokens "
                     f"at starts {starts[:b].tolist()}", max_abs_err=0.0,
                     max_abs_want=float(src.abs().max()), ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib, library="index_copy_ on the flat pool",
                     launches=served["paged_copy_at"]))

    # paged_prefill_attention (bf16 pools, then int8 pools)
    for tag, r, n_launch in (
            ("paged_prefill_attention", rec["paged_prefill_attention"],
             served["paged_prefill_attention"]),
            ("paged_prefill_attention_int8", rec_pq,
             counts["radix int8"]["paged_prefill_attention"])):
        (q, kp, vp, pt, starts), kw = r.best
        kw = dict(kw)
        kw.pop("use_kernel", None)
        page = kw["page_size"]
        b, s, hkv, g, d = q.shape
        chunks = r.extra[:b].tolist()
        st = starts[:b].tolist()
        got = paged_prefill_attention(q, kp, vp, pt, starts, **kw)
        want = ref.paged_prefill_attention_ref(q, kp, vp, pt, starts, **kw)
        real = torch.cat([(got[i, :c] - want[i, :c]).flatten()
                          for i, c in enumerate(chunks)])
        peak = max(float(want[i, :c].float().abs().max())
                   for i, c in enumerate(chunks) if c)
        err = float(real.float().abs().max())
        require(err <= 4 * 2**-8 * peak,
                f"{tag} err {err} > 4 * 2^-8 * max|want| ({peak}) at serve "
                "shapes")
        max_pages = pt.shape[1]
        kv_row = page * hkv * d * 2 * kp.element_size()   # one page, K + V
        needed = sum(min(-(-(x + c) // page), max_pages)
                     for x, c in zip(st, chunks))
        fetched = sum(pages_touched(x, s, max_pages, page_size=page,
                                    bq=query_block(g)) for x in st)
        # q read and o written for the real chunk rows (padded rows are
        # don't-care), each reached K/V page once, the starts and entries
        nbytes = (2 * sum(chunks) * hkv * g * d * q.element_size()
                  + needed * kv_row + b * 4 + needed * 4)
        flops = 4.0 * d * g * hkv * attended_pairs(st, chunks)
        ms = time_ms(lambda: paged_prefill_attention(q, kp, vp, pt, starts,
                                                     **kw))
        plain = time_ms(lambda: ref.paged_prefill_attention_ref(
            q, kp, vp, pt, starts, **kw))
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(name=tag, shape=f"q {list(q.shape)} {q.dtype}, "
                         f"pool {list(kp.shape)} {kp.dtype}, starts {st}, "
                         f"chunks {chunks}; kernel fetches "
                         f"{fetched * kv_row} B of K/V, the bound counts "
                         f"{needed * kv_row} B", max_abs_err=err,
                         max_abs_want=peak, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         library=None, launches=n_launch))
    print_rows(rows)
    return rows


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def rwkv_decode(model, params, logits, state, steps: int):
    """``steps`` greedy decode steps from prefill ``logits``; the tokens
    stay on the card.  Returns (tokens [B, steps + 1], every step's logits,
    state)."""
    import torch
    tok = logits.argmax(-1).to(torch.int32)
    toks, all_logits = [tok], [logits]
    for _ in range(steps):
        logits, state = model.decode_step(params, tok, state)
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        all_logits.append(logits)
    return torch.stack(toks, 1), all_logits, state


def expected_wkv_launches(tm_impl: str, prompt_len: int, layers: int,
                          decode_steps: int) -> dict[str, int]:
    """The launches of one prefill and ``decode_steps`` decode steps: the
    chunked kernel for a prefill iff ``tm_impl == "chunked_matmul"`` and
    the prompt is a multiple of 32 (JAX's rule), else the sequential one;
    every decode step (T = 1) runs the sequential kernel."""
    from repro_torch.kernels import ops
    route = ops.wkv6_route(prompt_len,
                           matmul_chunks=tm_impl == "chunked_matmul")
    want = {"wkv6": layers * decode_steps, "wkv6_chunked": 0}
    want[route] += layers
    return want


def reduced_rwkv_check() -> None:
    """The reduced rwkv6-7b (f32) on the card against the same model and
    weights on the CPU: prefill, then 16 greedy decode steps, for both
    ``tm_impl``s with 32-token prompts (the chunked kernel under
    ``chunked_matmul``) and 27-token prompts (the sequential kernel);
    identical tokens, logits and final state within 1e-4 (f32 sums in
    another order).  ``w_lora_B`` is drawn nonzero (the init makes it
    zero), so the data-dependent decay runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.rwkv6 import TM_IMPLS
    cfg = get_config("rwkv6-7b", reduced=True)
    cpu_params = build_model(cfg, device="cpu").init(0)
    gen = torch.Generator().manual_seed(5)
    for blk in cpu_params["blocks"]:
        blk["tm"]["w_lora_B"] = 0.5 * torch.randn(
            blk["tm"]["w_lora_B"].shape, generator=gen)
    gpu_params = to_device(cpu_params, "cuda")
    for tm_impl in TM_IMPLS:
        for plen in (32, 27):
            toks = torch.randint(0, cfg.vocab_size, (3, plen), generator=gen,
                                 dtype=torch.int32)
            lens = torch.full((3,), plen, dtype=torch.int32)
            runs = {}
            for tag, dev, params in (("card", "cuda", gpu_params),
                                     ("cpu", "cpu", cpu_params)):
                model = build_model(cfg, device=dev, tm_impl=tm_impl)
                ops.reset_launch_counts()
                logits, st = model.prefill(params, toks.to(dev), lens.to(dev),
                                           model.init_state(3))
                out, all_logits, st = rwkv_decode(model, params, logits, st,
                                                  16)
                runs[tag] = (out.cpu(), [x.cpu() for x in all_logits],
                             [x.cpu() for x in st], ops.launch_counts())
            (t_g, l_g, s_g, n_g), (t_c, l_c, s_c, _) = runs["card"], runs["cpu"]
            require(torch.equal(t_g, t_c), f"reduced rwkv6 ({tm_impl}, "
                                           f"prompt {plen}): tokens differ "
                                           "card vs cpu")
            err = max(close_err(a, b, 1e-4) for a, b in
                      zip(l_g + s_g[:3], l_c + s_c[:3]))
            require(err <= 1e-4 and torch.equal(s_g[3], s_c[3]),
                    f"reduced rwkv6 ({tm_impl}, prompt {plen}): logits or "
                    f"state off by {err}")
            want = expected_wkv_launches(tm_impl, plen, cfg.num_layers, 16)
            got = {k: n_g[k] for k in want}
            require(got == want, f"reduced rwkv6 ({tm_impl}, prompt {plen}): "
                                 f"launches {got}, expected {want}")
            log(f"check reduced rwkv6 ({tm_impl}, prompt {plen}): card == cpu "
                f"greedy tokens (prefill + 16 steps), logits and state within "
                f"1e-4; launches {json.dumps(got)}")
    ops.reset_launch_counts()


#: the full-width RWKV-6 workload: one batch of 8 equal 512-token prompts
#: (the JAX prefill is exact only for equal lengths), 32 greedy new tokens
RWKV = dict(batch=8, prompt=512, new=32, seed=4)
#: the context the example winds the state to (``long_500k``)
LONG_CONTEXT = 524_288 - 4


def rwkv_models():
    """rwkv6-7b at full width, one model per ``tm_impl`` sharing one set of
    random bf16 weights from a seeded generator, and the prompts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.rwkv6 import TM_IMPLS
    cfg = get_config("rwkv6-7b")          # all 32 layers: depth is not cut
    models = {impl: build_model(cfg, device="cuda", tm_impl=impl)
              for impl in TM_IMPLS}
    t0 = time.perf_counter()
    params = models["sequential"].init(0)
    torch.cuda.synchronize()
    log(f"rwkv: rwkv6-7b full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_rwkv_heads} heads of {cfg.rwkv_head_size}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16) initialised on the "
        f"card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    rng = np.random.default_rng(RWKV["seed"])
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (RWKV["batch"], RWKV["prompt"])).astype(
        np.int32)).cuda()
    return cfg, models, params, tokens


def rwkv_serve(model, params, tokens):
    """Prefill the batch, then greedy decode to ``RWKV["new"]`` tokens.
    Returns (tokens [B, new], prefill logits, state, prefill seconds,
    decode seconds); the clock stops after a synchronize."""
    import torch
    lens = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                      device=tokens.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, st = model.prefill(params, tokens, lens,
                               model.init_state(tokens.shape[0]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, _, st = rwkv_decode(model, params, logits, st, RWKV["new"] - 1)
    torch.cuda.synchronize()
    return out, logits, st, t1 - t0, time.perf_counter() - t1


def rwkv_phase(cfg, models, params, tokens) -> dict[str, dict[str, int]]:
    """Serve the batch with each ``tm_impl`` (after an untimed warm-up of
    the same shapes), the launch counts zeroed just before and read just
    after each run; then the long-context decode.  Returns each run's
    launch counts."""
    import torch
    from repro_torch.kernels import ops
    counts, first = {}, {}
    decode_steps = RWKV["new"] - 1
    for impl, model in models.items():
        rwkv_serve(model, params, tokens)       # warm-up: same shapes, untimed
        ops.reset_launch_counts()
        out, logits, st, pre_s, dec_s = rwkv_serve(model, params, tokens)
        launches = ops.launch_counts()
        counts[impl], first[impl] = launches, (logits.float(), out)
        want = expected_wkv_launches(impl, tokens.shape[1], cfg.num_layers,
                                     decode_steps)
        got = {k: launches[k] for k in want}
        require(got == want, f"rwkv {impl}: launches {got}, expected {want}")
        require(out.shape == (RWKV["batch"], RWKV["new"]), "rwkv: wrong shape")
        require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                f"rwkv {impl}: token outside the vocabulary")
        require(bool(torch.isfinite(logits).all()), f"rwkv {impl}: "
                                                    "non-finite logits")
        n_tok = out.numel()
        log(f"rwkv {impl}: {RWKV['batch']} requests x {RWKV['prompt']}-token "
            f"prompts, {n_tok} tokens in {pre_s + dec_s:.3f}s = "
            f"{n_tok / (pre_s + dec_s):.1f} tok/s; prefill (TTFT of the "
            f"batch) {pre_s * 1e3:.1f} ms, decode {dec_s / decode_steps * 1e3:.2f}"
            f" ms/step (TPOT) over {decode_steps} steps; launches "
            f"{json.dumps(got)}")
        if impl == "sequential":
            seq_state, seq_tpot = st, dec_s / decode_steps
            seq_tok = out[:, -1]
    (l_s, o_s), (l_c, o_c) = first["sequential"], first["chunked_matmul"]
    diff = float((l_s - l_c).abs().max())
    lead = [next((k for k in range(o_s.shape[1]) if o_s[i, k] != o_c[i, k]),
                 o_s.shape[1]) for i in range(o_s.shape[0])]
    log(f"rwkv: largest difference of the two runs' prefill logits {diff:.4g} "
        f"(max|logit| {float(l_s.abs().max()):.4g}); greedy tokens agree up "
        f"to positions {lead} (printed, not required)")

    # the example's point: the state is the only thing carried, O(1) in
    # context length
    model = models["sequential"]
    st = seq_state._replace(seq_lens=torch.full_like(seq_state.seq_lens,
                                                     LONG_CONTEXT))
    nbytes = st.nbytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = seq_tok
    for _ in range(4):
        logits, st = model.decode_step(params, tok, st)
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    long_s = (time.perf_counter() - t0) / 4
    require(st.nbytes == nbytes, f"state grew with context: {nbytes} -> "
                                 f"{st.nbytes} bytes")
    require(bool((st.seq_lens == LONG_CONTEXT + 4).all()), "seq_lens wrong")
    log(f"rwkv long context: 4 decode steps at ~{LONG_CONTEXT} tokens, "
        f"{long_s * 1e3:.2f} ms/step vs {seq_tpot * 1e3:.2f} ms/step at "
        f"{RWKV['prompt']}; state {nbytes} bytes before and after "
        f"(unchanged)")
    return counts


class WkvTap:
    """Wraps ``ops.wkv6``; keeps clones of the inputs of the largest call of
    each (route, prefill or decode), for the full-width checks."""

    def __init__(self, fn):
        self.fn, self.best = fn, {}

    def __call__(self, r, k, v, w, u, s0=None, **kw):
        from repro_torch.kernels import ops
        route = ops.wkv6_route(r.shape[1], use_kernel=kw.get("use_kernel",
                                                             True),
                               matmul_chunks=kw.get("matmul_chunks", False))
        key = (route, "decode" if r.shape[1] == 1 else "prefill")
        if key not in self.best or r.numel() > self.best[key][0].numel():
            self.best[key] = [None if x is None else x.clone()
                              for x in (r, k, v, w, u, s0)]
        return self.fn(r, k, v, w, u, s0, **kw)


def rwkv_profile(model, params, tokens, steps: int = 8) -> None:
    """An untimed, traced repeat (torch.profiler) of one prefill and
    ``steps`` decode steps (none when 0): the device's busy share of the
    wall clock and device time by kernel, for each half."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import print_profile
    lens = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                      device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, st = model.prefill(params, tokens, lens,
                                   model.init_state(tokens.shape[0]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"rwkv profile ({model.tm_impl}), prefill:")
    print_profile(prof, wall, top=8)
    if not steps:
        return
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rwkv_decode(model, params, logits, st, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"rwkv profile ({model.tm_impl}), {steps} decode steps:")
    print_profile(prof, wall, top=8)


def rwkv_record(models, params, tokens):
    """An untimed repeat of each run's prefill and first decode step with
    ``ops.wkv6`` wrapped in a :class:`WkvTap`."""
    import torch
    from repro_torch.kernels import ops
    tap = WkvTap(ops.wkv6)
    saved, ops.wkv6 = ops.wkv6, tap
    try:
        lens = torch.full((tokens.shape[0],), tokens.shape[1],
                          dtype=torch.int32, device="cuda")
        for model in models.values():
            logits, st = model.prefill(params, tokens, lens,
                                       model.init_state(tokens.shape[0]))
            model.decode_step(params, logits.argmax(-1).to(torch.int32), st)
    finally:
        ops.wkv6 = saved
    return tap.best


def bound_f32(nbytes: float, flops: float):
    """Least time on the card for f32 work: bytes over HBM bandwidth or
    operations over the f32 CUDA-core peak (67 TFLOP/s, H100 SXM data
    sheet), whichever is longer."""
    from repro_torch.core.costmodel import H100_HBM_BW, H100_PEAK_FLOPS_F32
    tb = nbytes / H100_HBM_BW * 1e3
    tf = flops / H100_PEAK_FLOPS_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def wkv_flops(chunked: bool, bh: int, t: int, n: int, c: int = 32) -> float:
    """The f32 operations of each formulation on these shapes.
    Sequential, per step and head: ``sum_i r_i S_ij`` (2 N^2), the bonus
    ``(r . u k) v_j`` (3 N + N) and ``S = w S + k v^T`` (3 N^2).  Chunked,
    per chunk of ``c`` and head: the log-decay cumsums (2 c N), the masked
    ``att`` (5 N per pair j < i: subtract, exp, two products, add) and its
    bonus diagonal (3 c N), the rescaled r and k (5 c N), the inter-chunk
    ``(r a) @ S`` (2 c N^2), ``att @ v`` (2 N per pair j <= i) and the
    state update (N^2 (2 c + 2))."""
    if not chunked:
        return float(bh * t * (5 * n * n + 4 * n))
    pairs = c * (c - 1) // 2
    per_chunk = (2 * c * n + 5 * n * pairs + 3 * c * n + 5 * c * n
                 + 2 * c * n * n + 2 * n * (pairs + c) + n * n * (2 * c + 2))
    return float(bh * -(-t // c) * per_chunk)


def wkv_checks(best, counts) -> list[dict]:
    """Each WKV kernel against its plain version at the largest input its
    own run gave it, then timings.  f32 tolerance 1e-3 of the largest
    output: up to 512-step f32 sums taken in another order.  The plain
    sequential version is a Python loop over T and is timed with fewer
    repeats."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked

    def chunked_plain(*a):
        return ref.wkv6_chunked_matmul_ref(*a, chunk=32)

    cases = (
        ("wkv6", ("wkv6", "prefill"), wkv6, ref.wkv6_ref, False,
         counts["sequential"]["wkv6"], dict(n=3, reps=3)),
        ("wkv6_decode", ("wkv6", "decode"), wkv6, ref.wkv6_ref, False,
         counts["chunked_matmul"]["wkv6"], {}),
        ("wkv6_chunked", ("wkv6_chunked", "prefill"), wkv6_chunked,
         chunked_plain, True, counts["chunked_matmul"]["wkv6_chunked"],
         dict(n=3, reps=3)),
    )
    rows = []
    for name, key, kern, plain, chunked, launches, plain_rep in cases:
        require(key in best, f"{name}: no call recorded on its path")
        args = best[key]
        r, s0 = args[0], args[5]
        got, want = kern(*args), plain(*args)
        err = max(max_err(g_, w_) for g_, w_ in zip(got, want))
        peak = max(float(w_.abs().max()) for w_ in want)
        require(err <= 1e-3 * peak, f"{name} err {err} > 1e-3 * max|want| "
                                    f"({peak}) at serve shapes")
        bh, t, n = r.shape
        nbytes = 4 * (5 * bh * t * n + bh * n + bh * n * n
                      * (2 if s0 is not None else 1))
        ms = time_ms(lambda: kern(*args))
        plain_ms = time_ms(lambda: plain(*args), **plain_rep)
        b_ms, b_by = bound_f32(nbytes, wkv_flops(chunked, bh, t, n))
        rows.append(dict(name=name, shape=f"r {list(r.shape)} {r.dtype}, "
                         f"initial state {'given' if s0 is not None else 'zero'}",
                         max_abs_err=err, max_abs_want=peak, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None,
                         library="none (no single PyTorch call computes a "
                                 "recurrence)", launches=launches))
    print_rows(rows)
    return rows


# ---------------------------------------------------------------------------
# the paper's VM loop: per-element translated gather, DTLB, matmul
# ---------------------------------------------------------------------------


def gather_operands(gen, dev, dtype, w, page, n, *, frames=40, max_pages=8):
    """A pool, one table row with a -1 entry, ``n`` positions in random
    order with a repeat and (for n > 4) two past the table's reach."""
    import torch
    shape = (frames, page, w)
    if dtype == torch.int8:
        pool = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)
    else:
        pool = torch.randn(shape, generator=gen, device=dev).mul(50).to(dtype)
    row = torch.randperm(frames, generator=gen, device=dev)[:max_pages].int()
    row[1] = -1
    pos = torch.randint(0, max_pages * page, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[-1] = pos[0]
    if n > 4:
        pos[:2] = torch.tensor([max_pages * page + 3, max_pages * page * 5],
                               dtype=torch.int32, device=dev)
    return pool, row, pos


#: the matmul shapes of tests/test_kernels.py and the paper's three problems
#: (benchmarks/bench_tlb_sweep.PROBLEMS: datasets of 6, 24 and 96 pages)
MATMUL_SHAPES = ((128, 128, 128), (256, 384, 128), (128, 512, 256),
                 (100, 70, 50), (1, 128, 128), (8, 1024, 8))
PAPER_N = (45, 90, 181)


def matmul_err(tag, got, want, tol) -> float:
    """``max|got - want|``; fails beyond ``tol * max|want|``."""
    err, peak = max_err(got, want), float(want.float().abs().max())
    require(err <= tol * peak, f"{tag}: err {err} > {tol} * max|want| "
                               f"({peak})")
    return err


def reduced_vm_checks() -> None:
    """``paged_gather`` bit-identical to its plain version over dtypes,
    widths, pages, orders, -1 entries, positions past the reach and N = 1;
    ``matmul`` against its plain version on the JAX tests' shapes in f32
    and bf16 with f32 output (within 1e-4 of the largest output: f32 sums
    in another order), a bf16 output (four bf16 steps) and the paper's
    sizes in f32."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.paged_gather import paged_gather
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for w in (4, 14, 512):
            for page in (8, 16):
                for n in (1, 300):
                    pool, row, pos = gather_operands(gen, dev, dtype, w,
                                                     page, n)
                    got = paged_gather(pool, row, pos, page_size=page)
                    want = ref.paged_gather_ref(pool, row, pos,
                                                page_size=page)
                    require(got.dtype == dtype and torch.equal(got, want),
                            f"paged_gather {dtype} W={w} page={page} N={n} "
                            "differs")
    torch.cuda.synchronize()
    log("check reduced: paged_gather f32/bf16/int8, W in (4, 14, 512), "
        "page 8/16, N 1/300, random order with repeats, -1 entries, past "
        "the reach: bit-identical")
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in MATMUL_SHAPES:
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            y = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            got = matmul(x, y, out_dtype=torch.float32)
            worst = max(worst, matmul_err(
                f"matmul {dtype} [{m},{k}]x[{k},{n}]", got,
                ref.matmul_ref(x, y, torch.float32), 1e-4))
            if dtype == torch.bfloat16:
                matmul_err(f"matmul bf16 -> bf16 [{m},{k}]x[{k},{n}]",
                           matmul(x, y), ref.matmul_ref(x, y), 4 * 2**-8)
    for n in PAPER_N:
        x, y = (torch.randn((n, n), generator=gen, device=dev)
                for _ in range(2))
        worst = max(worst, matmul_err(f"matmul f32 n={n}", matmul(x, y),
                                      ref.matmul_ref(x, y), 1e-4))
    torch.cuda.synchronize()
    log(f"check reduced: matmul f32/bf16 on the JAX test shapes (f32 and "
        f"bf16 outputs) and n = 45/90/181 f32 within 1e-4 of the largest "
        f"output (largest |err| {worst:.3g}), bf16 outputs within four bf16 "
        f"steps")
    ops.reset_launch_counts()


def quickstart_phase() -> dict[str, int]:
    """The port's quickstart on the card, launch counts zeroed just before
    and read just after, then on the CPU: the same printed lines."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart

    def lines(device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            quickstart.main(device=device)
        return buf.getvalue().splitlines()

    ops.reset_launch_counts()
    card = lines("cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    cpu = lines("cpu")
    require(card == cpu, f"quickstart: the card printed {card}, the CPU {cpu}")
    want = {"paged_copy": 1, "paged_gather": 1}
    require(launches == {**dict.fromkeys(launches, 0), **want},
            f"quickstart launches {launches}, expected {want}")
    for line in card:
        log(f"quickstart | {line}")
    log("quickstart: card == cpu, line for line; launches "
        + json.dumps({k: launches[k] for k in want}))
    return launches


#: one layer of qwen2-7b's K pool (Hkv 4 x head_dim 128 = 512, bf16, page
#: 16, 2,304 frames) and a 32,768-token sequence (2,048 pages)
GATHER = dict(page=16, frames=2304, tokens=32768, w=512)


def gather_phase(launches) -> list[dict]:
    """Map the sequence in scrambled frames, gather the four streams of
    ``benchmarks/bench_translation.py`` at 32,768 tokens through the
    kernel, the plain version and the coalesced route (bit-identical),
    print each stream's translation counts and 16-entry DTLB reports, and
    time the random stream.  The bound counts what the random stream
    needs: each distinct pool row and table entry read once, every output
    row written once, the positions read once."""
    import numpy as np
    import torch
    from repro_torch.core import (
        VECTOR,
        AccessEvent,
        SharedMMUSimulator,
        VMemConfig,
        VirtualMemory,
        burst_trace,
        element_trace,
    )
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_gather import paged_gather
    page, frames, tokens, w = (GATHER[k] for k in ("page", "frames",
                                                    "tokens", "w"))
    vm = VirtualMemory(VMemConfig(page_size=page, num_pages=frames,
                                  max_pages_per_seq=tokens // page,
                                  max_seqs=frames + 1))
    # one-page decoys fill the pool and leave in a random order, so the
    # LIFO free list hands the sequence scrambled frames
    decoys = frames
    for i in range(decoys):
        vm.map_seq(i + 1, page)
    for i in np.random.default_rng(6).permutation(decoys):
        vm.unmap_seq(int(i) + 1)
    seq = vm.map_seq(0, tokens)
    adjacent = int(np.sum(np.abs(np.diff(seq.pages)) == 1))
    dev = torch.device("cuda")
    row = vm.device_page_table("cpu")[seq.slot].to(dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    pool = torch.randn((frames, page, w), generator=gen,
                       device=dev).to(torch.bfloat16)
    log(f"gather: pool {list(pool.shape)} bf16 ({pool.numel() * 2 / 1e6:.1f} "
        f"MB, one layer of qwen2-7b's K pool), {tokens} tokens in {len(seq.pages)} "
        f"frames ({adjacent} of {len(seq.pages) - 1} neighbours in adjacent "
        f"frames after {decoys} decoys)")
    srng = np.random.default_rng(0)
    streams = {
        "unit_stride": np.arange(tokens),
        "strided_4": np.arange(0, tokens, 4),
        "random": srng.integers(0, tokens, size=tokens),
        "sorted_random": np.sort(srng.integers(0, tokens, size=tokens)),
    }
    for name, pos in streams.items():
        p = torch.as_tensor(pos.astype(np.int32), device=dev)
        got = paged_gather(pool, row, p, page_size=page)
        want = ref.paged_gather_ref(pool, row, p, page_size=page)
        coal = ops.paged_gather_coalesced(pool, row, p, page_size=page)
        require(torch.equal(got, want) and torch.equal(got, coal),
                f"gather {name}: kernel, plain and coalesced routes differ")
        reps = {}
        for label, tr in (("burst", burst_trace(pos, page)),
                          ("element", element_trace(pos, page)),
                          ("coalesced", burst_trace(np.sort(pos), page))):
            rep = SharedMMUSimulator(16).run(
                [AccessEvent(VECTOR, int(v), slack=4.0) for v in tr])
            reps[label] = (tr.size, rep)
        log(f"gather {name}: N {pos.size}, bit-identical (kernel, plain, "
            f"coalesced); translations and 16-entry DTLB (host numpy): "
            + "; ".join(f"{label} tx {n} misses {r.misses} stall "
                        f"{r.total_cycles:.0f} cyc"
                        for label, (n, r) in reps.items()))
    p = torch.as_tensor(streams["random"].astype(np.int32), device=dev)
    vpn = (p.long() // page).clamp(max=row.numel() - 1)
    flat_rows = row.long()[vpn].clamp(min=0) * page + p.long() % page
    flat = pool.view(-1, w)
    n = p.numel()
    distinct_rows = int(torch.unique(p).numel())
    distinct_pages = int(torch.unique(vpn).numel())
    nbytes = (distinct_rows + n) * w * 2 + 4 * n + 4 * distinct_pages
    ms = time_ms(lambda: paged_gather(pool, row, p, page_size=page))
    plain = time_ms(lambda: ref.paged_gather_ref(pool, row, p,
                                                 page_size=page))
    lib = time_ms(lambda: flat.index_select(0, flat_rows))
    coal_ms = time_ms(lambda: ops.paged_gather_coalesced(pool, row, p,
                                                         page_size=page))
    b_ms, b_by = bound(nbytes, 0)
    log(f"gather random: coalesced route {coal_ms:.4f} ms; the bound counts "
        f"{distinct_rows} distinct rows of {n} ({nbytes} B; every row read "
        f"would be {2 * n * w * 2 + 8 * n} B, "
        f"{bound(2 * n * w * 2 + 8 * n, 0)[0]:.4f} ms)")
    return [dict(name="paged_gather", shape=f"pool {list(pool.shape)} bf16, "
                 f"{n} random positions with repeats", max_abs_err=0.0,
                 max_abs_want=float(pool.float().abs().max()), ms=ms,
                 plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                 library_ms=lib, library="index_select on precomputed rows",
                 launches=launches["paged_gather"])]


#: qwen2-7b's gate projection for a 2,048-token prefill (d_model 3584,
#: d_ff 18944)
MATMUL_FULL = (2048, 3584, 18944)


def matmul_phase() -> list[dict]:
    """The paper's matmul through ``ops.matmul`` (launch counts zeroed just
    before, read just after): n = 45, 90, 181 in f32 and the full-width
    bf16 product; each against its plain version; then the full-width and
    the n = 181 products timed beside ``torch.matmul`` and their bounds
    (bf16 operations at the tensor-core peak; f32 at the CUDA-core peak)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.matmul import matmul
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    paper = {n: tuple(torch.randn((n, n), generator=gen, device=dev)
                      for _ in range(2)) for n in PAPER_N}
    m, k, n = MATMUL_FULL
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    ops.reset_launch_counts()
    outs = {nn: ops.matmul(*paper[nn]) for nn in PAPER_N}
    big = ops.matmul(x, y)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    require(launches == {**dict.fromkeys(launches, 0), "matmul": 4},
            f"matmul phase launches {launches}, expected matmul 4")
    errs, rel = {}, {}
    for nn in PAPER_N:
        want = ref.matmul_ref(*paper[nn])
        errs[nn] = matmul_err(f"matmul f32 n={nn}", outs[nn], want, 1e-4)
        rel[nn] = f"{errs[nn] / float(want.abs().max()):.3g}"
    want = ref.matmul_ref(x, y)
    err, peak = bf16_check("matmul", big, want)
    require(big.shape == (m, n) and big.dtype == torch.bfloat16
            and bool(torch.isfinite(big).all()), "matmul: wrong output")
    log(f"matmul: n = 45/90/181 f32 err / max|want| {rel} (within 1e-4); "
        f"[{m},{k}]x[{k},{n}] bf16 err {err:.3g} (max|want| {peak:.3g}); "
        f"launches {launches['matmul']}")
    del want, outs
    rows = []
    ms = time_ms(lambda: matmul(x, y), n=5, reps=3)
    plain = time_ms(lambda: ref.matmul_ref(x, y), n=5, reps=3)
    lib = time_ms(lambda: torch.matmul(x, y), n=5, reps=3)
    b_ms, b_by = bound(2 * (m * k + k * n + m * n), 2.0 * m * n * k)
    rows.append(dict(name="matmul", shape=f"x [{m}, {k}] @ y [{k}, {n}] "
                     "bf16 -> bf16", max_abs_err=err, max_abs_want=peak,
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib, library="torch.matmul bf16",
                     launches=launches["matmul"]))
    x, y = paper[181]
    ms = time_ms(lambda: matmul(x, y))
    plain = time_ms(lambda: ref.matmul_ref(x, y))
    lib = time_ms(lambda: torch.matmul(x, y))
    b_ms, b_by = bound_f32(4 * 3 * 181 * 181, 2.0 * 181 ** 3)
    rows.append(dict(name="matmul_f32", shape="x [181, 181] @ y [181, 181] "
                     "f32 (the paper's 96-page problem)", max_abs_err=errs[181],
                     max_abs_want=float(ref.matmul_ref(x, y).abs().max()),
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib, library="torch.matmul f32 (TF32 off)",
                     launches=launches["matmul"]))
    return rows


def vm_phases() -> list[dict]:
    """The quickstart, the full-size gather and the paper's matmul."""
    launches = quickstart_phase()
    rows = gather_phase(launches)
    rows += matmul_phase()
    print_rows(rows)
    return rows


def print_rows(rows) -> None:
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"kernel {r['name']}: {r['shape']}; err {r['max_abs_err']:.3g} "
            f"(max|want| {r['max_abs_want']:.3g}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{lib} ({r['library']}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['launches']} launches on its path")


def dense_phases() -> list[dict]:
    """The qwen2-7b phases (cold, int8, horizon, continuation) and their
    kernel rows; the model and every recorded input are freed on return."""
    cfg, model, params = full_model()
    launches, launches_q = serve_phase(cfg, model, params)
    counts = continuation_phase(cfg, model, params)
    rec, rec_q, rec_pq = record_inputs(cfg, model, params)
    rows = full_checks(rec, rec_q, launches, launches_q)
    rows += continuation_checks(rec, rec_pq, counts)
    return rows


def rwkv_phases() -> list[dict]:
    """The RWKV-6 serve runs, the long-context decode and the WKV rows."""
    cfg, models, params, tokens = rwkv_models()
    counts = rwkv_phase(cfg, models, params, tokens)
    best = rwkv_record(models, params, tokens)
    rows = wkv_checks(best, counts)
    del best
    for i, model in enumerate(models.values()):   # decode: the same code
        rwkv_profile(model, params, tokens, steps=8 if i == 0 else 0)
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this "
              "smoke needs one CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: FAIL: {SRC / 'repro_torch'} not found; run from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    quick = "--quick" in sys.argv[1:]
    try:
        probe()
        build()
        reduced_checks()
        reduced_wkv_checks()
        reduced_engine_check()
        reduced_rwkv_check()
        reduced_vm_checks()
        if quick:
            log("quick: stopping after the reduced checks")
            return 0
        rows = dense_phases()
        gc.collect()                   # free the qwen2-7b weights first
        torch.cuda.empty_cache()
        log(f"freed qwen2-7b: {torch.cuda.memory_allocated() / 1e9:.1f} GB "
            "allocated")
        rows += rwkv_phases()
        rows += vm_phases()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for r in rows:
        source, replaces = KERNELS[r["name"].removesuffix("_int8")
                                   .removesuffix("_decode")
                                   .removesuffix("_f32")]
        kernels.append(dict(
            name=r["name"], route="cuda", source=source, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
