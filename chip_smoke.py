#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves on the card.

    python3 chip_smoke.py            # one CUDA card, ~8 minutes
    python3 chip_smoke.py --quick    # build and the reduced checks only

Imports nothing of JAX and nothing of the JAX package (``src/repro``); it
puts ``src`` on ``sys.path`` and drives ``repro_torch``.  Phases, each
printing its lines; any failure exits non-zero before the last line:

1. probe: the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions, the TF32 switches (both set off: the f32 checks are f32);
2. build: every CUDA kernel of the serve path from ``src/repro_torch/
   kernels/csrc`` (one nvcc per source, in parallel), with its time and
   each kernel function's ptxas registers and spills;
3. reduced check: each kernel against its plain PyTorch version on the
   card at the reduced qwen2-7b shapes in f32 (D=14, G=2), with ragged
   lengths, -1 table entries, an empty sequence, a window, unaligned and
   page-aligned chunk starts, a 1-token chunk, tokens past the table and
   int8 pools (the copies also as pairs, K and V in one launch, on the
   burst route in f32 and the rows route in bf16 and int8); both WKV
   kernels in f32 at N = 8, 16, 32 and 64, T = 1, 17, 27, 64, 96 and
   512, with and without an initial state, the per-channel extreme
   decays {1e-6, 0.5, 1 - 1e-6, 1}, a state handed over between
   two calls, a decay of 1e-6 (and both WKV kernels' launch shapes at each
   N: threads, shared memory, blocks resident a SM); then the reduced
   engine on the card against
   the same engine on the CPU: the cold workload, the default-policy
   workload (radix prefix hits and partial restores) and a fork workload,
   with identical greedy tokens and counters; a router over 1, 2 and 4
   reduced engines on the card against the same router on the CPU
   (identical tokens, statuses, router and replica counters, switch
   stats), and the rescue of a stranded request, native and int8, card
   against CPU; ``ragged_dot`` in f32 against its plain version (empty
   groups, one group holding every row, rows past the last group), in
   bf16 on its ``"mma"`` and ``"wgmma"`` routes (groups ending inside a
   tile, launched twice for bit-identical outputs) and
   the reduced granite-moe and llama4 engines (f32; llama4 routes every
   other layer) on the card against the CPU, cold, int8 and default
   policy, with identical tokens and counters; the reduced qwen2-vl
   (M-RoPE) and musicgen (``[len, 4]`` codebook prompts, ``[4]`` tokens a
   step) engines likewise, with identical switch stats; and the reduced
   rwkv6-7b
   (prefill + 16 greedy decode steps, both ``tm_impl``s, 32- and 27-token
   prompts) on the card against the CPU: identical tokens, logits within
   1e-4;
4. serve: qwen2-7b at full width (bf16, random weights from a seeded
   generator) serves 8 requests (64-512-token prompts, 32 new tokens,
   page 16, horizon 8) cold, in a pool tight enough to preempt; launch
   counts are zeroed just before and read just after, and every kernel of
   the cold path must have launched, every ``flash_attention`` launch on
   its tensor-core (``wgmma``) route, every ``paged_copy`` launch on its
   burst route and one a layer of each ``prefill`` call (a layer's K and
   V in one launch); then a short int8-pool run, and a short workload
   that must give the same greedy tokens at horizon 8 and 1;
5. continuation serve: the default policy (radix prefix cache, partial
   restore) at full width — a radix run (8 prompts sharing 0, 128 or 256
   tokens of one base) in a 64-frame pool that preempts and restores
   partially, a fork run (8 ``share_prefix`` requests on a preloaded
   200-token prompt) and a short int8 radix run; each zeroes the launch
   counts before and reads them after, and both continuation kernels must
   have launched in each, both copies on the burst route, one launch a
   layer of each ``prefill`` / ``prefill_continue`` call.  Every serve
   run from here on replays the executor's CUDA graphs (captured when its
   engine is built), which add the launches their captures recorded to
   the counters, unless it says otherwise;
6. graphs: the cold, int8, radix and fork runs each once with the graphs
   and once inside ``disable_graphs()`` (eager, one launch at a time),
   identical in greedy tokens, counters, switch stats, kernel launches
   and routes, with TPOT p50, TTFT p50 and tokens/s printed for both;
   then traced (torch.profiler) cold and default-policy runs of both
   modes print the device's busy share, kernels per decode token-step,
   the device-to-host copies by their source (the spill, the host
   sampling, the token block read) and, where a prefill copies K/V, each
   copy's start after its predecessor's end;
7. buckets: the radix run with ``aot_buckets=(128, 256, 512)``, graphs
   against ``disable_graphs()`` (identical as in 6), ``aot_hits`` > 0 and
   ``aot_misses`` equal to the batches wider than 512, one copy launch a
   layer of each prefill counted by replays and eager calls, token
   agreement and first-token logits against the unbucketed run (each
   fresh row within eight bf16 steps of its largest logit: 28 bf16
   layers amplify the GEMMs' last-bit differences between shapes); traced
   bucketed runs, native and int8, graphs and eager, for the copies'
   programmatic edges;
8. router: a ``ReplicaRouter`` over 2 engines of 4 lanes on the one
   weight set (least-loaded, migration on), each run zeroing the launch
   counts before its engines are built and reading them after the
   drain, with graphs and inside ``disable_graphs()`` (identical in
   tokens, statuses, router and replica counters, switch stats, fleet
   launches and routes; no migration aborted; every replica placed and
   decoding): router-cold (the cold workload, 36 frames a replica)
   beside the N=1 graph run of the same call, with its token agreement,
   and traced; router-radix (the radix workload, 35 frames a replica:
   ``prefix_hits`` > 0, the continuation kernels on their fast routes);
   router-rescue, native and int8 (a 384-token request stranded on a
   25-frame replica is migrated to a 72-frame one: restored frames equal
   to the record's bytes, tokens equal to a lone engine's, the record's
   bytes and the export, import and restore times printed); then the
   card's allocated bytes after 1, 2 and 4 engines;
9. full-width check and timing (the serve runs repeated eagerly, since
   the recorders read each call's inputs): each kernel against its plain version on
   the largest inputs an untimed repeat of the serve runs gave it (bf16,
   within four bf16 steps of the largest output; copies bit-identical),
   then the device time of kernel, plain version and one PyTorch library
   call that computes the same function (a yardstick the port never
   calls), from CUDA events around 50 back-to-back calls with a cold L2;
   each copy is timed as the serve path launches it (K and V in one
   launch, beside two ``index_copy_`` calls), for one tensor, and as its
   floor (the same launch with ``lens`` all 0, which moves nothing),
   beside the least time the card could take (bytes / 3.35 TB/s or
   operations / 989 TFLOP/s bf16); ``flash_attention`` is also timed at
   a 4,096-token qwen2-7b prefill (q [1, 28, 4096, 128]) beside SDPA;
10. RWKV-6 serve: the qwen2-7b weights are freed, rwkv6-7b at full width
   (32 layers, d_model 4096, 64 heads of 64, bf16, random weights, depth
   not cut) prefills 8 prompts of 512 tokens and decodes 32 greedy tokens,
   once with ``tm_impl="sequential"`` (``wkv6`` everywhere) and once with
   ``"chunked_matmul"`` (``wkv6_chunked`` for the prefill); launch counts
   are zeroed before and read after each run; then the state is wound to
   524,284 tokens and 4 more steps must leave its bytes unchanged;
11. WKV full-width check and timing: each WKV kernel against its plain
   version (f32, within 1e-3 of the largest output) on the largest inputs
   an untimed repeat gave it (prefill, decode at T = 1, chunked prefill),
   timed as in 9, beside bytes / 3.35 TB/s or f32 operations / 67 TFLOP/s
   (the CUDA-core peak: the kernels compute in f32); then a traced,
   untimed repeat of each run's prefill and of 8 decode steps prints the
   device's busy share and device time by kernel, and each prefill's
   ``wkv6`` and ``wkv6_chunked`` time and share of device time;
12. MoE: the rwkv6-7b weights are freed, granite-moe-1b-a400m at full
   width (24 layers, d_model 1024, 32 experts top-8, bf16, random
   weights, depth not cut) serves a cold run (8 prompts of 256-640
   tokens: one prefill of 2,560 tokens takes the per-row sorted dispatch,
   the rest the ragged one; a preemption), an int8 run and a radix run,
   each with CUDA graphs and inside ``disable_graphs()``, identical in
   tokens, counters, switch stats, launches and routes (``ragged_dot``'s
   launches per route as ``ragged_route`` implies for each ragged
   dispatch: decode on ``"mma"``, prefills on ``"wgmma"``, both
   printed); the count of each dispatch, tok/s, TTFT, TPOT;
   the cold run traced in both modes (busy share, kernels per decode
   token-step); the three runs and the radix workload on int8 pools
   repeated untimed inside ``disable_graphs()`` with the recorders of 9,
   and each copy and attention kernel held against its plain version on
   the largest call it got there (Hkv 8, G 2, head_dim 64; on its Hopper
   route, the copies bit-identical, attention within the tolerance of 9);
   then the kernel path against the plain path
   (``use_kernels=False``) in bf16, teacher forced over one prefill and 8
   decode steps, and, as the witness that tells rounding from a fault,
   both paths in f32 on the same weights and tokens: each call's worst
   row error relative to its peak and the share of (token, layer) expert
   sets alike, kernel vs plain in bf16 and in f32 and each bf16 path
   against the f32 plain path (printed, not required);
   ``ragged_dot`` launches per decode token-step; ``ragged_dot`` against
   its plain version at the full-width shapes (decode 32 rows, a
   2,048-token prefill of 16,384 rows, both products, an empty expert,
   one expert holding every row; each on its route, ``bf16_rows_check``,
   rows past the last group zero, two launches bit-identical) and timed
   beside its plain version, ``torch._grouped_mm`` and its bound, the
   route printed at each shape;
13. VLM: the granite-moe weights are freed, qwen2-vl-7b at full width
   (28 layers, qwen2-7b's shapes, M-RoPE sections (16, 24, 24), bf16,
   random weights, depth not cut) serves the cold workload of 4 and a
   default-policy radix run, each with CUDA graphs and inside
   ``disable_graphs()`` (identical tokens, counters, switch stats,
   launches and routes; every attention and copy launch on its Hopper
   route; one copy launch a layer of each prefill), the cold run traced
   in both modes; a direct ``prefill`` of 2 x 512 tokens whose first 256
   positions are a stub vision prefix (patch embeddings, normal x 0.02),
   kernel path against plain path (within 32 bf16 steps of each row's
   peak and well below the prefix's own shift); the kernel path's logits
   against the plain path's, teacher forced (2 x 256 tokens, 8 decode
   steps), in bf16 and on f32 weights (printed, not required); tok/s,
   TTFT and TPOT p50, traced busy share and kernels per decode
   token-step beside the card's name and power limit;
14. audio: the qwen2-vl-7b weights are freed, musicgen-large at full
   width (48 layers, d_model 2048, 32 heads of 64 with 32 KV heads (G
   1), 4 codebooks of 2048, bf16, depth not cut) serves ``[len, 4]``
   prompts: the cold workload, an int8 run and a default-policy radix
   run whose pool preempts and restores, each with graphs and eager as
   in 13, the cold run traced; the runs repeated untimed with the
   recorders of 9 and each copy and attention kernel held against its
   plain version on the largest call it got (Hkv 32, G 1, head_dim 64,
   page 16; on its Hopper route, the tolerances of 9); the G 1 rows of
   both paged attention kernels timed as in 9, with the audio runs'
   launches;
15. the paper's VM loop (after the reduced checks above, which also hold
   ``paged_gather`` bit-identical to its plain version over f32/bf16/int8,
   W 4/14/512, page 8/16, any order with repeats, -1 entries, positions
   past the reach and N = 1, and ``matmul`` within 1e-4 of the largest
   output, four bf16 steps for a bf16 output, on the JAX kernel tests'
   shapes and the paper's n = 45/90/181): the quickstart
   (``repro_torch.launch.quickstart``) on the card and on the CPU must
   print the same lines, with ``paged_copy`` 1 and ``paged_gather`` 1
   launches (the gather on its ``"lanes"`` route: 16-byte rows); then one
   layer of qwen2-7b's K pool (W = 512, bf16, page 16, 2,304 frames)
   holds a 32,768-token sequence in scrambled frames, and four streams
   (unit stride, stride 4, random with repeats, sorted random) are
   gathered bit-identical through the kernel (on its ``"bulk"`` route),
   the plain version and the coalesced route, with each stream's
   translation counts and 16-entry DTLB report (host numpy); each stream
   is timed beside ``index_select`` in 11 batches of each, taken in
   turns, each batch printed with both medians and spreads, the stream's
   own bound and whether the kernel is behind, level with or ahead of the
   call beyond the spread; the random stream again with a read-filled L2
   (a 128 MB read before each call instead of the write); then a pool
   larger than the L2 (9,216 frames, 151 MB) holding a 131,072-token
   sequence, read at 32,768 random positions, bit-identical and timed
   likewise under both fills (printed, off the kernels line);
16. the paper's matmul: n = 45, 90, 181 in f32 and qwen2-7b's gate
   projection for a 2,048-token prefill (bf16 [2048, 3584] @ [3584,
   18944] -> bf16) through ``ops.matmul`` with the launch counts zeroed
   before and read after (the f32 products on the CUDA-core route, the
   gate projection on ``wgmma``), each against its plain version, then
   the largest and the n = 181 product timed beside ``torch.matmul``;
17. the kernel JSON line, then the device JSON line, last.
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
    # not a TPU kernel: jax.lax.ragged_dot, which XLA lowers itself
    "ragged_dot": ("src/repro_torch/kernels/csrc/ragged_dot.cu",
                   "src/repro/models/moe.py:132"),
}


#: the card's name and power limit (``nvidia-smi``), set by :func:`probe`
CARD = "not probed"


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
    return statistics.median(paired_batches((fn,), n, reps)[0])


def paired_batches(fns, n: int = 50, reps: int = 5, *,
                   fill: str = "write") -> list[list[float]]:
    """Per-batch device times of one call of each of ``fns``, as
    :func:`time_ms` takes them: ``reps`` batches of each, taken in turns
    (a b, b a, a b, ...) so a drift of the card falls on all alike, each
    less the median of the L2-evicting passes alone.  ``fill="write"``
    writes the 128 MB before each call, which leaves the L2 full of dirty
    lines that the call's own traffic must write back; ``fill="read"``
    reads them instead, which leaves it full of clean lines."""
    import torch
    if fill not in ("write", "read"):
        raise ValueError(f"fill must be 'write' or 'read', got {fill!r}")
    flush = _flush_buffer()
    words = flush.view(torch.int64)

    def evict():
        if fill == "write":
            flush.zero_()
        else:
            words.amax()

    def flushed(fn):
        def call():
            evict()
            fn()
        return call

    def flush_only():
        evict()

    both = [[] for _ in fns]
    for i in range(reps):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            both[j].append(_batch_ms(flushed(fns[j]), n))
    alone = statistics.median(_batch_ms(flush_only, n) for _ in range(reps))
    return [[(b - alone) / n for b in bs] for bs in both]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def bf16_check(tag, got, want) -> tuple[float, float]:
    """``(max|got - want|, max|want|)``; fails beyond four bf16 steps of
    the largest output."""
    err, peak = max_err(got, want), float(want.float().abs().max())
    require(err <= 4 * 2**-8 * peak,
            f"{tag} err {err} > 4 * 2^-8 * max|want| ({peak}) at serve shapes")
    return err, peak


def bf16_rows_check(tag, got, want) -> tuple[float, float]:
    """``(max|got - want|, max|want|)`` of attention outputs ``[..., S, D]``;
    fails where a row's error passes four bf16 steps of that row's largest
    output, ``4 * 2**-8 * max_d |want[..., s, d]|``.  A row that averages
    thousands of keys is ~100x smaller than one that sees a few, so a
    tolerance on the largest output of all would pass a dropped key tile
    or a wrong rescale on the long rows."""
    diff = (got.float() - want.float()).abs().amax(-1)
    row_peak = want.float().abs().amax(-1)
    excess = diff - 4 * 2**-8 * row_peak
    worst = int(excess.argmax())
    if float(excess.flatten()[worst]) > 0:
        idx = tuple(int(i) for i in unravel(worst, excess.shape))
        raise SmokeFailure(
            f"{tag}: row {idx} err {float(diff[idx])} > 4 * 2^-8 * its "
            f"max|want| ({float(row_peak[idx])})")
    return float(diff.max()), float(row_peak.max())


def unravel(flat: int, shape) -> list[int]:
    out = []
    for n in reversed(shape):
        out.append(flat % n)
        flat //= n
    return out[::-1]


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
    global CARD
    CARD = card
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
        fn = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif any(w in line for w in ("registers", "spill", "arning",
                                         "Performance")):
                log(f"  ptxas {name} {short_name(fn)}: {line.strip()}")


def short_name(mangled: str) -> str:
    """A kernel's demangled name without its namespaces' prefix and
    parameter list, e.g. ``tc::matmul_wgmma_kernel<__nv_bfloat16>``
    (``c++filt``; the mangled name where it is missing)."""
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return mangled
    name = (out or mangled).replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


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
    from repro_torch.kernels.paged_copy import (
        paged_copy, paged_copy_at, paged_copy_kv, paged_copy_kv_at)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention,
    )
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = 1e-5
    ops.reset_launch_counts()
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
        src_v = src.flip(1)
        got = paged_copy_kv(src, src_v, pool.clone(), pool.clone(), table,
                            lens, page_size=page)
        want = (want, ref.paged_copy_ref(src_v, pool.clone(), table, lens,
                                         page_size=page))
        require(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
                f"paged_copy_kv {dtype} differs")
    log("check reduced: paged_copy and the pair paged_copy_kv f32/bf16/int8 "
        "bit-identical; routes "
        + json.dumps(ops.route_counts()["paged_copy"]))
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
        src_v = src.flip(1)
        got = paged_copy_kv_at(src, src_v, pool.clone(), pool.clone(), table,
                               starts, lens, page_size=page)
        want = (want, ref.paged_copy_at_ref(src_v, pool.clone(), table,
                                            starts, lens, page_size=page))
        require(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
                f"paged_copy_kv_at {dtype} differs")
    routes = ops.route_counts()
    require(routes["paged_copy"] == routes["paged_copy_at"]
            == {"burst": 2, "rows": 4},
            f"reduced copies: f32 rows of 112 bytes take the burst route, "
            f"bf16 and int8 (56 and 28) the rows route: {routes}")
    log("check reduced: paged_copy_at and the pair paged_copy_kv_at "
        "f32/bf16/int8 bit-identical on the whole pool; routes "
        + json.dumps(routes["paged_copy_at"]))
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
    routes = ops.route_counts()
    require(routes["paged_decode_attention"] == {"mma": 0, "simt": 4}
            and routes["paged_prefill_attention"] == {"wgmma": 0, "simt": 2},
            f"reduced f32 paged attention off the CUDA-core routes: {routes}")
    log("check reduced: f32 paged attention on the CUDA-core routes: "
        + json.dumps({k: routes[k] for k in PAGED_TC}))
    ops.reset_launch_counts()


def close_err(got, want, tol) -> float:
    """``max(|got - want| - tol * |want|)``: at most ``tol`` when the two
    agree within ``atol = rtol = tol`` (``torch.testing.assert_close``)."""
    return float(((got.float() - want.float()).abs()
                  - tol * want.float().abs()).max())


#: a per-channel mix of extreme decays, repeated over the channels
MIXED_DECAYS = (1e-6, 0.5, 1 - 1e-6, 1.0)


def wkv_operands(gen, dev, bh, t, n, *, state, decay=None):
    """f32 r, k, v (scale 0.5), w = sigmoid(z - 1), a constant decay or
    (``decay="mixed"``) the per-channel :data:`MIXED_DECAYS`, u, and an
    optional initial state (scale 0.1), as the CPU tests draw them."""
    import torch

    def f(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev) * sc
    r, k, v = f(bh, t, n, sc=0.5), f(bh, t, n, sc=0.5), f(bh, t, n, sc=0.5)
    if decay is None:
        w = torch.sigmoid(f(bh, t, n) - 1.0)
    elif decay == "mixed":
        row = torch.tensor(MIXED_DECAYS, device=dev).repeat(n // 4)
        w = row.expand(bh, t, n).contiguous()
    else:
        w = torch.full((bh, t, n), decay, device=dev)
    return r, k, v, w, f(bh, n, sc=0.5), (f(bh, n, n, sc=0.1) if state
                                          else None)


def reduced_wkv_checks() -> None:
    """Both WKV kernels against their plain versions on the card, f32, at
    the tolerances of their CPU tests against the Pallas kernels: 1e-4
    sequential, 3e-4 chunked (the chunked form takes every decay as an exp
    of a cumsum of logs), 1e-3 at a decay of 1e-6; every head size the
    kernels take, T up to 512, the sigmoid draw and the per-channel
    extreme decays (:data:`MIXED_DECAYS`, also within 1e-3 of the step
    loop)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.wkv6 import HEAD_SIZES, launch_config, wkv6
    from repro_torch.kernels.wkv6_chunked import launch_config as ck_config
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    kernels = (("wkv6", wkv6, ref.wkv6_ref, 1e-4),
               ("wkv6_chunked", wkv6_chunked,
                lambda *a: ref.wkv6_chunked_matmul_ref(*a, chunk=32), 3e-4))
    for name, config in (("wkv6", launch_config),
                         ("wkv6_chunked", ck_config)):
        for n in HEAD_SIZES:
            cfg = config(n)
            log(f"{name} launch at N={n}: one block of {cfg['threads']} "
                f"threads a head, {cfg['smem_bytes']} B shared memory, "
                f"{cfg['blocks_per_sm']} blocks resident a SM")
    for name, kern, plain, tol in kernels:
        worst = 0.0
        for n in HEAD_SIZES:
            for t in (1, 17, 27, 64, 96, 512):
                for state, decay in ((False, None), (True, None),
                                     (True, "mixed")):
                    args = wkv_operands(gen, dev, 6, t, n, state=state,
                                        decay=decay)
                    got = kern(*args)
                    for g_, w_ in zip(got, plain(*args)):
                        err = close_err(g_, w_, tol)
                        require(err <= tol, f"{name} N={n} T={t} "
                                            f"state={state} decay={decay}: "
                                            f"off by {err}")
                        worst = max(worst, max_err(g_, w_))
                    if decay == "mixed":
                        require(all(bool(torch.isfinite(x).all())
                                    and close_err(x, y, 1e-3) <= 1e-3
                                    for x, y in zip(got, ref.wkv6_ref(*args))),
                                f"{name} N={n} T={t}: extreme decays off "
                                "the step loop")
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
        log(f"check reduced: {name} f32 N in {HEAD_SIZES}, T in (1, 17, 27, "
            f"64, 96, 512), with and without a state, extreme decays, "
            f"handoff, decay 1e-6 within {tol} (largest |err| {worst:.3g})")
    ops.reset_launch_counts()


def to_device(p, dev):
    """A params tree (dicts and lists of tensors) on ``dev``, or in a dtype
    (``Tensor.to`` takes either)."""
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
    radix = reduced_radix_workload(cfg.vocab_size)
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


def reduced_radix_workload(vocab: int, tok: tuple = ()):
    """The shared-base workload of tests/test_torch_continuation.py: 7
    prompts, the first 8 tokens of one base and a 4-13-token tail each
    (``tok``: a token's trailing shape, ``(K,)`` for audio codebooks)."""
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(13)
    base = rng.integers(0, vocab, size=(12,) + tok).astype(np.int32)
    return [ServeRequest(req_id=i, max_new_tokens=12, prompt=np.concatenate(
        [base[:8], rng.integers(0, vocab, size=(int(
            rng.integers(4, 14)),) + tok).astype(np.int32)]))
        for i in range(7)]


def reduced_router_check() -> None:
    """The router over N in {1, 2, 4} reduced engines on the card (graphs
    replayed) against the same router over the same weights on the CPU,
    on the default policy's shared-base workload in a tight pool: greedy
    tokens, statuses, every router and replica counter (less
    ``prefill_bytes_gathered``, which counts by the route that ran) and
    switch stats; then the rescue of a stranded request at reduced width,
    native and int8, on the card and on the CPU: identical tokens,
    counters and record bytes."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig
    cfg = get_config("qwen2-7b", reduced=True)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(0)
    gpu_model = build_model(cfg, device="cuda")
    gpu_params = to_device(cpu_params, "cuda")
    reqs = reduced_radix_workload(cfg.vocab_size)
    scfg = ServeConfig(page_size=4, num_pages=16, max_pages_per_seq=16,
                       max_batch=3)

    def record(run):
        counters = {i: {k: v for k, v in c.items()
                        if k != "prefill_bytes_gathered"}
                    for i, c in run["counters"].items()}
        return run["tokens"], counters, run["switch"]

    for n in (1, 2, 4):
        card = routed(gpu_model, gpu_params, [scfg] * n, reqs, graphs=True)
        cpu = routed(cpu_model, cpu_params, [scfg] * n, reqs, graphs=True)
        require(record(card) == record(cpu),
                f"reduced router N={n}: card and cpu differ")
        require(all(r.status == "done" for r in card["res"].values()),
                f"reduced router N={n}: a request did not finish")
        merged = card["router"].global_counters()
        log(f"check reduced router N={n}: card == cpu greedy tokens, "
            f"statuses, router and replica counters, switch stats; "
            f"preemptions {merged['preemptions']}, prefix_hits "
            f"{merged['prefix_hits']}, restore_migrations "
            f"{merged['restore_migrations']}, placements "
            + ", ".join(str(merged[f"placements_replica{i}"])
                        for i in range(n)))
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=24).astype(np.int32)
    for kv in ("native", "int8"):
        big = ServeConfig(page_size=4, num_pages=64, max_pages_per_seq=32,
                          max_batch=3, max_horizon=1, kv_dtype=kv)
        card = rescue_run(gpu_model, gpu_params, big, 8, prompt, 8)
        cpu = rescue_run(cpu_model, cpu_params, big, 8, prompt, 8)
        for c in (card["counters"], cpu["counters"]):
            c.pop("prefill_bytes_gathered", None)
        require((card["tokens"], card["counters"], card["bytes"])
                == (cpu["tokens"], cpu["counters"], cpu["bytes"]),
                f"reduced rescue ({kv}): card and cpu differ")
        log(f"check reduced rescue ({kv}): the stranded request migrates "
            f"(restore_migrations 1), its {card['bytes']} B record restored "
            "bit for bit, tokens equal the lone engine's and the cpu's")


def serve_workload(vocab: int, n: int, lo: int, hi: int, max_new: int,
                   seed: int, tok: tuple = ()):
    """``n`` requests of ``lo``-``hi``-token prompts (``tok``: a token's
    trailing shape, ``(K,)`` for audio codebooks)."""
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(req_id=i, prompt=rng.integers(
        0, vocab, size=(int(rng.integers(lo, hi + 1)),) + tok).astype(
            np.int32), max_new_tokens=max_new) for i in range(n)]


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
#: the paged attention kernels and their tensor-core routes
PAGED_TC = {"paged_decode_attention": "mma",
            "paged_prefill_attention": "wgmma"}
#: the copies and their route for the serve path's views
COPY_FAST = {"paged_copy": "burst", "paged_copy_at": "burst"}


def require_tensor_core_routes(tag, launches) -> dict:
    """Every launch of both paged attention kernels in a full-width run is
    on its tensor-core route, and every launch of both copies on the burst
    route; returns the route counts."""
    from repro_torch.kernels import ops
    routes = ops.route_counts()
    for name, tc in {**PAGED_TC, **COPY_FAST}.items():
        require(routes[name] == {**dict.fromkeys(routes[name], 0),
                                 tc: launches[name]},
                f"{tag}: {name} off its {tc} route: {routes[name]}")
    return routes


class PrefillTap:
    """Within ``with``: counts the ``prefill`` and ``prefill_continue``
    calls of ``model``'s class (the engine's int8 twin is a copy of the
    model, so the class is patched, not the instance), so a run can
    require one K/V copy launch a layer of each
    (``require_copy_launches``)."""

    NAMES = ("prefill", "prefill_continue")

    def __init__(self, model):
        self.cls, self.calls = type(model), dict.fromkeys(self.NAMES, 0)
        self.saved = {n: self.cls.__dict__[n] for n in self.NAMES}

    def __enter__(self):
        for name, fn in self.saved.items():
            setattr(self.cls, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def counted(model, *args, **kw):
            self.calls[name] += 1
            return fn(model, *args, **kw)
        return counted

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)

    def require_copy_launches(self, tag, launches, layers: int) -> None:
        """One pair launch a layer of every prefill: K and V share it."""
        want = {"paged_copy": layers * self.calls["prefill"],
                "paged_copy_at": layers * self.calls["prefill_continue"]}
        got = {k: launches[k] for k in want}
        require(got == want, f"{tag}: copy launches {got}, want one a layer "
                             f"of each prefill {want}")

#: the continuation phase: the default policy (radix prefix cache on,
#: partial restore after 6 blocked restore passes), page 16, horizon 8, 4
#: lanes.  64 frames (1 scratch): the schedule depends on lengths only, and
#: a CPU run of it with the reduced model gave no partial restore at 72
#: frames, one at 68 and three at 64
CONT = dict(page_size=16, num_pages=64, max_pages_per_seq=36, max_batch=4,
            max_horizon=8)


def radix_workload(vocab: int, n: int = 8, seed: int = 2, max_new: int = 32,
                   tok: tuple = ()):
    """Prompt i is the first 0, 128 or 256 tokens (by ``i % 3``) of one
    256-token base, then a 16-256-token tail of its own (``tok``: a
    token's trailing shape)."""
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(256,) + tok).astype(np.int32)
    return [ServeRequest(req_id=i, max_new_tokens=max_new, prompt=np.concatenate(
        [base[: (0, 128, 256)[i % 3]], rng.integers(0, vocab, size=(int(
            rng.integers(16, 257)),) + tok).astype(np.int32)]))
        for i in range(n)]


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
    with PrefillTap(model) as tap:
        eng, res, dt = run_engine(model, params, scfg, reqs)
    launches = ops.launch_counts()
    report("serve", eng, res, dt)
    log("serve launches: " + json.dumps(launches))
    c, st = eng.counters, eng.stats()["switch_stats"]
    for n in COLD_KERNELS:
        require(launches[n] > 0, f"{n} was never launched on the serve path")
    routes = ops.route_counts()
    log("serve routes: " + json.dumps(routes))
    require(routes["flash_attention"] == {
        "wgmma": launches["flash_attention"], "simt": 0},
        f"flash_attention off the tensor-core route: {routes}")
    require_tensor_core_routes("serve", launches)
    tap.require_copy_launches("serve", launches, cfg.num_layers)
    log(f"serve: {tap.calls['prefill']} prefill calls x {cfg.num_layers} "
        f"layers = {launches['paged_copy']} paged_copy launches, each "
        "writing K and V")
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
    with PrefillTap(model) as tap:
        eng, res, dt = run_engine(
            model, params, dataclasses.replace(scfg, kv_dtype="int8"),
            serve_workload(cfg.vocab_size, **SHORT))
    launches_q = ops.launch_counts()
    report("serve int8", eng, res, dt)
    log("serve int8 launches: " + json.dumps(launches_q))
    log("serve int8 routes: " + json.dumps(
        require_tensor_core_routes("serve int8", launches_q)))
    tap.require_copy_launches("serve int8", launches_q, cfg.num_layers)
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
    from repro_torch.kernels.paged_prefill_attention import query_block

    counts = {}
    for tag, scfg, prefix, reqs in continuation_runs(cfg):
        ops.reset_launch_counts()
        with GatherTap() as tap, PrefillTap(model) as calls:
            eng, res, dt = run_engine(model, params, scfg, reqs, prefix)
        launches = ops.launch_counts()
        counts[tag] = launches
        report(tag, eng, res, dt, CONT_KEYS)
        log(f"{tag} launches: " + json.dumps(launches))
        log(f"{tag} routes: " + json.dumps(
            require_tensor_core_routes(tag, launches)))
        calls.require_copy_launches(tag, launches, cfg.num_layers)
        log(f"{tag}: {calls.calls} model calls, one K/V copy launch a layer "
            "of each")
        c = eng.counters
        require(tap.counted == c.get("prefill_bytes_gathered"),
                f"{tag}: the gather tap missed a continuation call")
        log(f"{tag}: prefill_bytes_gathered on the card {tap.counted} with "
            f"the tensor-core route's block (bq "
            f"{query_block(cfg.q_per_kv, 'wgmma')}); {tap.simt} with the "
            f"CUDA-core block (bq {query_block(cfg.q_per_kv, 'simt')}) that "
            "counted it through PR 15")
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


# ---------------------------------------------------------------------------
# CUDA graphs: the compiled serve programs against their eager runs
# ---------------------------------------------------------------------------


def graph_runs(cfg):
    """``(tag, ServeConfig, prefix, requests)`` of the graph phase: the
    cold, int8, radix and fork runs above."""
    from repro_torch.serve import ServeConfig
    scfg = ServeConfig(**SERVE)
    radix, fork = continuation_runs(cfg)[:2]
    return (("cold", scfg, None, serve_workload(cfg.vocab_size, **WORKLOAD)),
            ("int8", dataclasses.replace(scfg, kv_dtype="int8"), None,
             serve_workload(cfg.vocab_size, **SHORT)),
            radix, fork)


def served(model, params, scfg, reqs, prefix=None, *, graphs: bool):
    """One run (as :func:`run_engine`, and the engine's build time) with the
    launch counts zeroed before the engine is built and read after the
    drain; with ``graphs=False`` inside ``disable_graphs()``."""
    import contextlib
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, disable_graphs
    ops.reset_launch_counts()
    with contextlib.nullcontext() if graphs else disable_graphs():
        t0 = time.perf_counter()
        eng = Engine(model, params, scfg)
        build = time.perf_counter() - t0
        if prefix is not None:
            eng.preload_prefix(prefix)
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        t0 = time.perf_counter()
        res = eng.drain()
        dt = time.perf_counter() - t0
        eng.close()
    return dict(eng=eng, res=res, dt=dt, build=build,
                tokens=token_lists(res),
                counters=dict(eng.counters.counters),
                switch=eng.stats()["switch_stats"],
                launches=ops.launch_counts(), routes=ops.route_counts(),
                replays=eng.executor.replays)


def token_lists(res) -> dict:
    """Each request's tokens as nested lists (an audio token is a ``[K]``
    array), so two runs compare with ``==``."""
    import numpy as np
    return {i: np.asarray(r.tokens).tolist() for i, r in res.items()}


def require_same(tag, g, e) -> None:
    """A graph run and its eager twin: identical greedy tokens, counters
    (timers are not counters), switch stats, kernel launches and routes."""
    for key in ("tokens", "counters", "switch", "launches", "routes"):
        if g[key] != e[key]:
            diff = {k: (g[key].get(k), e[key].get(k))
                    for k in set(g[key]) | set(e[key])
                    if g[key].get(k) != e[key].get(k)}
            raise SmokeFailure(f"{tag}: graph and eager runs differ in "
                               f"{key}: {diff}")


def replays_of(replays, *kinds) -> int:
    """Replays of the programs of ``kinds`` (``Executor.replays``)."""
    return sum(n for (k, _), n in replays.items() if k in kinds)


class Annotations:
    """Within ``with``: ``torch.profiler.record_function`` ranges around
    the executor's decode steps (``decode``), its host sampling
    (``sample``) and the context switch's spill (``spill``), so a trace
    can say which device work and which device-to-host copy each caused."""

    SPANS = {"decode": ("repro_torch.serve.executor", "Executor",
                        ("decode", "decode_multi")),
             "sample": ("repro_torch.serve.executor", "Executor",
                        ("sample",)),
             "spill": ("repro_torch.core.context_switch", "ContextSwitcher",
                       ("spill_kv",))}

    def __enter__(self):
        import importlib
        from torch.profiler import record_function
        self.saved = []
        for label, (mod, cls, names) in self.SPANS.items():
            owner = getattr(importlib.import_module(mod), cls)
            for name in names:
                fn = owner.__dict__[name]
                self.saved.append((owner, name, fn))

                def wrapped(*a, _fn=fn, _label=label, **kw):
                    with record_function(_label):
                        return _fn(*a, **kw)
                setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def trace_split(prof, wall_s: float, token_steps: int) -> dict:
    """From a traced serve run: the device's busy share (the sum of device
    event times over the wall clock, as ``launch/serve.py --profile``
    counts it), kernels and their device time per decode token-step
    (kernels issued inside a ``decode`` range, over the token-steps) and
    the ranges' own wall time per token-step, the device-to-host copies
    by the innermost range that issued them (``spill``; ``sample``;
    ``decode`` outside ``sample``: the token block read), each device
    event placed in the ranges by the time of the host call that issued
    it (the same correlation id) where the trace has it, and each
    ``paged_copy`` kernel's gap from the end of the kernel before it on
    its stream."""
    import bisect
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                   if e.device_type() == DeviceType.CPU
                   and e.name() in Annotations.SPANS)
    dev = [e for e in events if e.device_type() != DeviceType.CPU
           and e.name() not in Annotations.SPANS]
    # the host call that issued each device event (same correlation id):
    # its time is on the host's clock, as the spans are
    issued = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() == DeviceType.CPU
              and e.name().startswith("cu") and e.correlation_id()}

    def host_ns(e):
        return issued.get(e.correlation_id(), e.start_ns())
    busy_ns = sum(e.duration_ns() for e in dev)
    kernels = sorted((e for e in dev if not e.name().startswith(
        ("Memcpy", "Memset"))), key=lambda e: e.start_ns())
    decode = [(s, t) for s, t, n in spans if n == "decode"]
    starts = [s for s, _ in decode]
    in_decode = decode_ns = 0
    for k in kernels:
        i = bisect.bisect_right(starts, host_ns(k)) - 1
        if i >= 0 and host_ns(k) <= decode[i][1]:
            in_decode += 1
            decode_ns += k.duration_ns()
    d2h = dict.fromkeys(("spill", "sample", "decode", "other"), 0)
    n_d2h = dict.fromkeys(d2h, 0)
    for e in dev:
        if "DtoH" not in e.name():
            continue
        inside = [(s, n) for s, t, n in spans if s <= host_ns(e) <= t]
        label = max(inside)[1] if inside else "other"
        d2h[label] += e.duration_ns()
        n_d2h[label] += 1
    matched = sum(e.correlation_id() in issued for e in dev)
    gaps, before, prev = [], {}, {}
    for k in kernels:
        stream = k.device_resource_id()
        if "paged_copy" in k.name() and stream in prev:
            p = prev[stream]
            gaps.append((k.start_ns() - p.end_ns()) / 1e3)
            name = p.name()[:48]
            before[name] = before.get(name, 0) + 1
        prev[stream] = k
    return dict(busy_ms=busy_ns / 1e6, share=busy_ns / 1e7 / wall_s,
                matched=(matched, len(dev)),
                kernels_per_step=in_decode / max(token_steps, 1),
                device_ms_per_step=decode_ns / 1e6 / max(token_steps, 1),
                wall_ms_per_step=sum(t - s for s, t in decode) / 1e6
                / max(token_steps, 1),
                d2h_ms={k: v / 1e6 for k, v in d2h.items()}, d2h_n=n_d2h,
                gaps_us=sorted(gaps), before=before)


def traced_run(tag, model, params, scfg, reqs, prefix=None, *,
               graphs: bool) -> dict:
    """Serve under ``torch.profiler`` (CPU and CUDA activities) with the
    :class:`Annotations`; prints the :func:`trace_split` of the run."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Engine, disable_graphs
    with contextlib.nullcontext() if graphs else disable_graphs():
        eng = Engine(model, params, scfg)
        if prefix is not None:
            eng.preload_prefix(prefix)
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        with Annotations(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.drain()
            dt = time.perf_counter() - t0
        eng.close()
    steps = eng.counters.get("decode_horizon")
    split = trace_split(prof, dt, steps)
    d2h = sum(split["d2h_ms"].values())
    log(f"{tag} traced: device busy {split['busy_ms']:.1f} ms of "
        f"{dt * 1e3:.1f} ms wall ({split['share']:.1f}% busy); "
        f"{split['kernels_per_step']:.1f} kernels and "
        f"{split['device_ms_per_step']:.2f} ms of kernel time per decode "
        f"token-step in {split['wall_ms_per_step']:.2f} ms of the host's "
        f"decode calls ({steps} token-steps, "
        f"{replays_of(eng.executor.replays, 'decode', 'decode_multi')} "
        f"decode graph replays; {split['matched'][0]} of "
        f"{split['matched'][1]} device events placed by their host call's "
        "time, the rest by their own)")
    log(f"{tag} traced device-to-host copies: {d2h:.2f} ms "
        f"({100 * d2h / max(split['busy_ms'], 1e-9):.1f}% of device busy): "
        + ", ".join(f"{k} {v:.2f} ms x{split['d2h_n'][k]}"
                    for k, v in split["d2h_ms"].items()))
    gaps = split["gaps_us"]
    if gaps:
        log(f"{tag} traced paged_copy start after its predecessor's end: "
            f"median {statistics.median(gaps):.2f} us, p10 "
            f"{gaps[len(gaps) // 10]:.2f} us, min {gaps[0]:.2f} us over "
            f"{len(gaps)} copies; predecessors {json.dumps(split['before'])}")
    return split


def graph_phase(cfg, model, params) -> None:
    """The compiled serve programs at full width: each of the cold, int8,
    radix and fork runs once with CUDA graphs (the default) and once
    inside ``disable_graphs()``, identical in greedy tokens, counters,
    switch stats and kernel launches and routes; then traced cold and
    default-policy runs of each mode."""
    runs_ = graph_runs(cfg)
    for tag, scfg, prefix, reqs in runs_:
        runs = {mode: served(model, params, scfg, reqs, prefix,
                             graphs=mode == "graph")
                for mode in ("graph", "eager")}
        for mode, r in runs.items():
            report(f"graphs {tag} {mode}", r["eng"], r["res"], r["dt"],
                   CONT_KEYS)
            log(f"graphs {tag} {mode}: engine built in {r['build']:.2f}s")
        g, e = runs["graph"], runs["eager"]
        require_same(f"graphs {tag}", g, e)
        require(replays_of(g["replays"], "decode", "decode_multi") > 0
                and e["replays"] == {},
                f"graphs {tag}: no decode replay in the graph run, or a "
                "replay in the eager run")
        require_tensor_core_routes(f"graphs {tag}", g["launches"])
        for n in COLD_KERNELS if tag in ("cold", "int8") else CONT_KERNELS:
            require(g["launches"][n] > 0, f"graphs {tag}: {n} never launched")
        log(f"graphs {tag}: graph == eager in greedy tokens, counters, "
            f"switch stats, launches and routes; replays "
            + json.dumps({f"{k}:{n}": c for (k, n), c in g["replays"].items()})
            + "; launches " + json.dumps(g["launches"]))
        del runs, g, e
    for tag, scfg, prefix, reqs in (runs_[0], runs_[2]):
        for mode in ("graph", "eager"):
            traced_run(f"graphs {tag} {mode}", model, params, scfg, reqs,
                       prefix, graphs=mode == "graph")


class BatchTap:
    """Within ``with``: the burst-aligned width of every prompt batch the
    executor pads (cold and continuation prefill alike)."""

    def __enter__(self):
        import repro_torch.serve.executor as X
        self.cls, self.widths = X.Executor, []
        self.orig = X.Executor._pad_prompt_batch
        tap = self

        def counted(ex, reqs, bucket=None):
            page = ex.cfg.page_size
            tap.widths.append(-(-max(len(r.prompt) for r in reqs) // page)
                              * page)
            return tap.orig(ex, reqs, bucket=bucket)
        self.cls._pad_prompt_batch = counted
        return self

    def __exit__(self, *exc):
        self.cls._pad_prompt_batch = self.orig


class FreshLogits:
    """Within ``with``: the logits of every prefill row whose request has
    no output yet (its inputs are its prompt alone), by request id."""

    NAMES = ("prefill", "admit_forked_batch", "sample")

    def __enter__(self):
        import repro_torch.serve.executor as X
        self.cls, self.logits, self.rows = X.Executor, {}, None
        self.saved = {n: X.Executor.__dict__[n] for n in self.NAMES}
        tap = self

        def admit(fn):
            def call(ex, reqs, *a, **kw):
                tap.rows = [None if r.output else r.req_id for r in reqs]
                try:
                    return fn(ex, reqs, *a, **kw)
                finally:
                    tap.rows = None
            return call

        def sample(ex, logits):
            for i, rid in enumerate(tap.rows or ()):
                if rid is not None:
                    tap.logits[rid] = logits[i].float().cpu()
            return tap.saved["sample"](ex, logits)
        self.cls.prefill = admit(self.saved["prefill"])
        self.cls.admit_forked_batch = admit(self.saved["admit_forked_batch"])
        self.cls.sample = sample
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.cls, n, fn)


#: the bucket phase's buckets: the radix run's batches are 16-512 tokens
#: wide, burst-aligned
BUCKETS = (128, 256, 512)
#: bucketed against unbucketed first-token logits, in bf16 steps of the
#: row's largest logit
LOGIT_STEPS = 8


def bucket_phase(cfg, model, params) -> None:
    """The bucket programs at full width: the radix run with
    ``aot_buckets=(128, 256, 512)``, with graphs and inside
    ``disable_graphs()`` (identical tokens, counters, launches and
    routes; ``aot_hits`` > 0 and ``aot_misses`` equal to the batches wider
    than 512), one copy launch a layer of every prefill, counted by
    replays and by the eager calls of the misses; against the unbucketed
    run, the token agreement and the first-token logits of every fresh
    request (the GEMMs' shapes change with the bucket, so cuBLAS may pick
    another algorithm); traced bucketed runs, native and int8, with graphs
    and eager, for the copies' start after their predecessors; last, each
    fresh row's logits within ``LOGIT_STEPS`` bf16 steps of its largest
    logit."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine
    tag, scfg, prefix, reqs = continuation_runs(cfg)[0]
    bcfg = dataclasses.replace(scfg, aot_buckets=BUCKETS)
    with BatchTap() as widths, FreshLogits() as plain_logits:
        plain = served(model, params, scfg, reqs, graphs=True)
    misses = sum(w > max(BUCKETS) for w in widths.widths)
    runs = {}
    for mode in ("graph", "eager"):
        with FreshLogits() as fresh:
            runs[mode] = served(model, params, bcfg, reqs,
                                graphs=mode == "graph")
        runs[mode]["fresh"] = fresh.logits
        report(f"buckets {tag} {mode}", runs[mode]["eng"], runs[mode]["res"],
               runs[mode]["dt"], CONT_KEYS + ("aot_hits", "aot_misses",
                                              "bucket_pad_tokens"))
        log(f"buckets {tag} {mode}: engine built in "
            f"{runs[mode]['build']:.2f}s")
    g, e = runs["graph"], runs["eager"]
    require_same(f"buckets {tag}", g, e)
    c = g["counters"]
    require(c.get("aot_hits", 0) > 0, f"buckets {tag}: no aot hit")
    require(c.get("aot_misses", 0) == misses,
            f"buckets {tag}: {c.get('aot_misses', 0)} misses, want {misses} "
            f"(batch widths {widths.widths})")
    require(c["aot_hits"] + misses == len(widths.widths),
            f"buckets {tag}: hits + misses != {len(widths.widths)} batches")
    require(replays_of(g["replays"], "prefill", "continue") == c["aot_hits"],
            f"buckets {tag}: replays {g['replays']} != aot_hits "
            f"{c['aot_hits']}")
    # one K/V copy launch a layer of every prefill: replays on the hits,
    # eager calls on the misses (the tap is set after the engine's build,
    # whose warm-ups and captures call the model's prefills)
    eng = Engine(model, params, bcfg)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    ops.reset_launch_counts()
    with PrefillTap(model) as tap:
        eng.drain()
    eng.close()
    launches, rp = ops.launch_counts(), eng.executor.replays
    want = {"paged_copy": cfg.num_layers * (
                replays_of(rp, "prefill") + tap.calls["prefill"]),
            "paged_copy_at": cfg.num_layers * (
                replays_of(rp, "continue") + tap.calls["prefill_continue"])}
    require({k: launches[k] for k in want} == want,
            f"buckets {tag}: copy launches {launches}, want {want}")
    log(f"buckets {tag}: graph == eager; aot_hits {c['aot_hits']}, "
        f"aot_misses {c.get('aot_misses', 0)} (batches wider than "
        f"{max(BUCKETS)}: {misses} of {len(widths.widths)}), "
        f"bucket_pad_tokens {c.get('bucket_pad_tokens', 0)}; replays "
        + json.dumps({f"{k}:{b}": n for (k, b), n in g["replays"].items()
                      if k in ("prefill", "continue")})
        + f"; one copy launch a layer of each of {replays_of(rp, 'prefill')}"
        f" + {replays_of(rp, 'continue')} replays and {tap.calls} eager "
        "calls")
    same = sum(g["tokens"][i] == plain["tokens"][i] for i in g["tokens"])
    require(len(g["fresh"]) > 0, f"buckets {tag}: no fresh prefill row")
    steps = {}
    for rid, row in sorted(g["fresh"].items()):
        want_row = plain_logits.logits[rid]
        steps[rid] = float((row - want_row).abs().max()) / (
            2**-8 * float(want_row.abs().max()))
    log(f"buckets {tag} vs unbucketed: {same}/{len(g['tokens'])} requests "
        f"give the same greedy tokens, "
        f"{sum(g['tokens'][i][0] == plain['tokens'][i][0] for i in steps)}"
        f"/{len(steps)} fresh requests the same first token; first-token "
        f"logits differ by at most {max(steps.values()):.2f} bf16 steps of "
        "the row's largest logit (2^-8 of it), by request: "
        + json.dumps({i: round(v, 2) for i, v in steps.items()}))
    del runs, g, e, plain
    short = radix_workload(cfg.vocab_size, n=4, max_new=16)
    for kv in ("native", "int8"):
        for mode in ("graph", "eager"):
            traced_run(f"buckets radix {kv} {mode}", model, params,
                       dataclasses.replace(bcfg, kv_dtype=kv), short,
                       graphs=mode == "graph")
    # 28 bf16 layers amplify the GEMMs' last-bit differences where padding
    # moves a batch to another cuBLAS kernel: up to 5.0 steps measured on
    # one-request batches padded to four rows, 0 on a 3-request batch
    # (four steps was the first guess); one pad column leaking into each
    # real row fails this bound by far
    worst = max(steps, key=steps.get)
    require(steps[worst] <= LOGIT_STEPS,
            f"buckets {tag}: request {worst}'s first-token logits differ "
            f"from the unbucketed run's by {steps[worst]:.2f} bf16 steps > "
            f"{LOGIT_STEPS}")


# ---------------------------------------------------------------------------
# the multi-replica serve path: ReplicaRouter over engines on one card
# ---------------------------------------------------------------------------

#: the router runs: 2 replicas of 4 lanes on one weight set, each with half
#: the frames of the N=1 run — cold 36 of 72; radix 35, not 32 of 64: a
#: 512 + 32-token request needs 34 usable pages, and a CPU run of the
#: reduced model (the schedule depends on lengths only) fails one request
#: as unreachable at 32 frames and hosts every one from 35 up
ROUTER_REPLICAS = 2
ROUTER_COLD = dict(SERVE, num_pages=36)
ROUTER_RADIX = dict(CONT, num_pages=35)
#: the rescue at full width: one 384-token request, 32 new tokens, horizon
#: 1; the small replica's 24 usable frames can never hold it (385 tokens
#: after the prefill need 25 pages), the roomy one has the cold run's 72
RESCUE = dict(prompt=384, new=32, small_pages=25, seed=5)
#: engines per memory reading after the build
MEMORY_FLEETS = (1, 2, 4)


def routed(model, params, scfgs, reqs, *, graphs: bool, prefix=None,
           policy="least_loaded", traced=False) -> dict:
    """Serve ``reqs`` through a router over one engine per ``scfgs`` entry
    on one weight set (each preloaded with ``prefix``), as a user drives
    it: launch counts zeroed before the engines are built and read after
    the drain; ``graphs=False`` inside ``disable_graphs()``; ``traced``
    under torch.profiler with the :class:`Annotations`.  Requires
    ``check_invariants()`` and returns the run's record."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, ReplicaRouter, disable_graphs
    ops.reset_launch_counts()
    prof = None
    with contextlib.nullcontext() if graphs else disable_graphs():
        t0 = time.perf_counter()
        engines = [Engine(model, params, s) for s in scfgs]
        build = time.perf_counter() - t0
        router = ReplicaRouter(
            [e.as_replica(i) for i, e in enumerate(engines)], policy=policy)
        if prefix is not None:
            for e in engines:
                e.preload_prefix(prefix)
        for r in reqs:
            router.submit(dataclasses.replace(r))
        with contextlib.ExitStack() as stack:
            if traced:
                stack.enter_context(Annotations())
                prof = stack.enter_context(profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            t0 = time.perf_counter()
            res = router.drain()
            dt = time.perf_counter() - t0
        for e in engines:
            e.close()
    router.check_invariants()
    # keyed as a single run's record (``served``), so ``require_same``
    # compares a router run with its twin: the router's counters and
    # every replica's (by id), every replica's switch stats
    return dict(router=router, engines=engines, res=res, dt=dt, build=build,
                prof=prof, tokens={i: (r.tokens, r.status)
                                   for i, r in res.items()},
                counters={"router": dict(router.counters.counters)} | {
                    i: dict(e.counters.counters)
                    for i, e in enumerate(engines)},
                switch={i: e.stats()["switch_stats"]
                        for i, e in enumerate(engines)},
                launches=ops.launch_counts(), routes=ops.route_counts(),
                replays=[e.executor.replays for e in engines])


def report_router(tag, run) -> None:
    """One line of end-to-end numbers and one of the router's counters."""
    res = run["res"]
    toks = sum(len(r.tokens) for r in res.values())
    require(toks > 0 and run["dt"] > 0, f"{tag}: no tokens")
    done = [r for r in res.values() if r.status == "done"]
    ttft = sorted(r.ttft for r in done)[len(done) // 2] * 1e3
    tpot = sorted(r.tpot for r in done)[len(done) // 2] * 1e3
    merged = run["router"].global_counters()
    log(f"{tag}: {len(done)}/{len(res)} done, {toks} tokens in "
        f"{run['dt']:.3f}s = {toks / run['dt']:.1f} tok/s; TTFT p50 "
        f"{ttft:.1f} ms, TPOT p50 {tpot:.2f} ms; preemptions "
        f"{merged['preemptions']}, restores "
        f"{merged['restores']}, partial_restores "
        f"{merged['partial_restores']}, restore_migrations "
        f"{merged['restore_migrations']}; engines built in "
        f"{run['build']:.2f}s")
    log(f"{tag} router counters: " + json.dumps(run["counters"]["router"]))


def router_fleet_checks(tag, run, kernels) -> None:
    """What every router run must show: all requests done, each replica
    placed and decoded, no plain-path step, no migration aborted, and each
    kernel of ``kernels`` launched on its fast route."""
    require(all(r.status == "done" for r in run["res"].values()),
            f"{tag}: a request did not finish")
    rc = run["counters"]["router"]
    for i in range(len(run["engines"])):
        c = run["counters"][i]
        require(rc.get(f"placements_replica{i}", 0) > 0
                and c.get("decode_tokens", 0) > 0,
                f"{tag}: replica {i} was not placed or never decoded")
        require(c.get("ref_path_dispatches", 0) == 0,
                f"{tag}: plain-path dispatches on replica {i}")
    require(rc.get("migration_aborts", 0) == 0, f"{tag}: migration aborted")
    for n in kernels:
        require(run["launches"][n] > 0, f"{tag}: {n} never launched")
    require_tensor_core_routes(tag, run["launches"])


def memory_phase(model, params) -> None:
    """Allocated bytes on the card after building 1, 2 and 4 cold-run
    engines over the one weight set, and after freeing them: each engine
    adds its pools, page table, buffers and graphs, never a copy of the
    weights, and the captures' shared warm-up stream leaves one cuBLAS
    workspace, not one an engine."""
    import torch
    from repro_torch.serve import Engine, ServeConfig
    scfg = ServeConfig(**SERVE)
    weights = sum(t.numel() * t.element_size()
                  for t in torch.utils._pytree.tree_leaves(params))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    added = {}
    for n in MEMORY_FLEETS:
        engines = [Engine(model, params, scfg) for _ in range(n)]
        torch.cuda.synchronize()
        added[n] = torch.cuda.memory_allocated() - base
        while engines:
            engines.pop().close()
        gc.collect()
    left = torch.cuda.memory_allocated() - base
    log(f"router memory: weights {weights / 1e9:.2f} GB held once; "
        + ", ".join(f"{n} engine(s) add {b / 1e6:.1f} MB"
                    for n, b in added.items())
        + f"; {left / 1e6:.1f} MB left after they are freed")
    one = added[1]
    for n, b in added.items():
        require(b <= n * one + (64 << 20),
                f"router memory: {n} engines add {b} B, more than {n} x "
                f"one engine's {one} B")
    require(one < weights / 10, f"router memory: one engine adds {one} B "
                                f"of {weights} B weights")


def rescue_run(model, params, big, small_pages: int, prompt, new: int
               ) -> dict:
    """JAX's ``test_rescue_migration_moves_real_kv_between_pools``: one
    request is served alone by a roomy engine (the reference), then
    through a router over a small replica (``small_pages`` frames, which
    can never host it) and a roomy one (``big``).  Placed on the roomy
    replica by reach, decoded until its footprint outgrows the small
    pool, spilled and stranded on the small replica (``export_swapped`` /
    ``import_swapped``), it must be rescued: ``restore_migrations`` 1, no
    request failed, the destination's restored frames bit-identical to
    the record, greedy tokens those of the lone engine, and neither
    switcher holding a record at the end.  Returns the record's bytes,
    the wall time of the rescue's export, import and restore, and the
    tokens."""
    import torch
    from repro_torch.serve import Engine, ReplicaRouter, ServeRequest
    sreq = ServeRequest(req_id=0, prompt=prompt, max_new_tokens=new)
    lone = Engine(model, params, big)
    lone.submit(dataclasses.replace(sreq))
    want = lone.drain()[0].tokens
    lone.close()
    e_small = Engine(model, params, dataclasses.replace(
        big, num_pages=small_pages))
    e_big = Engine(model, params, big)
    router = ReplicaRouter([e_small.as_replica(0), e_big.as_replica(1)],
                           migrate_after=2)
    router.submit(dataclasses.replace(sreq))
    require(router.counters.get("placements_replica1") == 1,
            "rescue: the reach check did not place on the roomy replica")
    s0, s1 = e_small.scheduler, e_big.scheduler
    while not (0 in s1.running and s1.vmem.config.pages_for(
            s1.vmem.seq_len(0)) > s0.attainable_pages()):
        router.step()
    s1.spill(s1.running[0])
    s0.import_swapped(s1.export_swapped(0))       # strand it: real bytes
    require(e_small.switcher.swapped_out == [0], "rescue: not stranded")
    seen, wall = {}, dict.fromkeys(("export", "import", "restore"), 0.0)

    def sync():
        if e_big.executor.device.type == "cuda":
            torch.cuda.synchronize(e_big.executor.device)

    def timed(name, fn, after=None):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            wall[name] += time.perf_counter() - t0
            if after is not None:
                after(out, *a)
            return out
        return run

    def keep_record(exp, *_):
        seen["record"] = exp.record.page_data

    def keep_frames(_, seq_id, k_pools, v_pools, *__):
        frames = e_big.vmem.seq(seq_id).pages
        seen["k"], seen["v"] = (p[:, frames].cpu()
                                for p in (k_pools, v_pools))
        seen["replays"] = dict(e_big.executor.replays)

    s0.export_swapped = timed("export", s0.export_swapped, keep_record)
    s1.import_swapped = timed("import", s1.import_swapped)
    e_big.switcher.restore_kv = timed("restore", e_big.switcher.restore_kv,
                                      keep_frames)
    res = router.drain()
    e_small.close()
    e_big.close()
    g = router.global_counters()
    require(g["restore_migrations"] == 1 and g["failed_unreachable"] == 0,
            f"rescue: restore_migrations {g['restore_migrations']}, "
            f"failed_unreachable {g['failed_unreachable']}")
    require(g.get("migration_aborts", 0) == 0, "rescue: migration aborted")
    require("k" in seen and torch.equal(seen["k"], seen["record"][0])
            and torch.equal(seen["v"], seen["record"][1]),
            "rescue: the restored frames differ from the record's bytes")
    require(res[0].tokens == want, f"rescue: tokens {res[0].tokens} != the "
                                   f"lone engine's {want}")
    require(e_small.switcher.swapped_out == e_big.switcher.swapped_out == [],
            "rescue: a switcher still holds a record")
    router.check_invariants()
    rec = seen["record"]
    return dict(bytes=rec.numel() * rec.element_size(), shape=list(rec.shape),
                dtype=str(rec.dtype).removeprefix("torch."), wall=wall,
                tokens=res[0].tokens, replays_before=seen["replays"],
                replays=e_big.executor.replays,
                counters=dict(g), router=router)


def router_phase(cfg, model, params) -> None:
    """The multi-replica serve path at full width on one card: the cold
    and radix workloads through a router over 2 engines on the one weight
    set, each with CUDA graphs and inside ``disable_graphs()`` (identical
    in tokens, every router and replica counter, switch stats, launches
    and routes), the cold one beside the N=1 graph run and traced; the
    rescue of a stranded request, native and int8; the card's allocated
    bytes after 1, 2 and 4 engines."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeConfig
    n = ROUTER_REPLICAS
    reqs = serve_workload(cfg.vocab_size, **WORKLOAD)
    one = served(model, params, ServeConfig(**SERVE), reqs, graphs=True)
    report("router-cold N=1 graph", one["eng"], one["res"], one["dt"])
    runs = {mode: routed(model, params, [ServeConfig(**ROUTER_COLD)] * n,
                         reqs, graphs=mode == "graph")
            for mode in ("graph", "eager")}
    for mode, run in runs.items():
        report_router(f"router-cold {mode}", run)
    g = runs["graph"]
    require_same("router-cold", g, runs["eager"])
    router_fleet_checks("router-cold", g, COLD_KERNELS)
    require(all(replays_of(r, "decode", "decode_multi") > 0
                for r in g["replays"]), "router-cold: a replica replayed "
                                        "no decode graph")
    log("router-cold: graph == eager in tokens, statuses, router and "
        "replica counters, switch stats, launches and routes; launches "
        + json.dumps(g["launches"]))
    same = sum(g["res"][i].tokens == one["tokens"][i] for i in one["tokens"])
    log(f"router-cold vs N=1: {same}/{len(reqs)} requests give the same "
        "greedy tokens (printed, not required: the GEMMs' row counts "
        "differ)")
    del runs, one
    traced = routed(model, params, [ServeConfig(**ROUTER_COLD)] * n, reqs,
                    graphs=True, traced=True)
    steps = sum(e.counters.get("decode_horizon") for e in traced["engines"])
    split = trace_split(traced["prof"], traced["dt"], steps)
    log(f"router-cold traced: device busy {split['busy_ms']:.1f} ms of "
        f"{traced['dt'] * 1e3:.1f} ms wall ({split['share']:.1f}% busy); "
        f"{split['kernels_per_step']:.1f} kernels and "
        f"{split['device_ms_per_step']:.2f} ms of kernel time per decode "
        f"token-step ({steps} token-steps over {n} replicas); "
        "device-to-host " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in split["d2h_ms"].items()))
    del traced, split

    radix = radix_workload(cfg.vocab_size)
    runs = {mode: routed(model, params, [ServeConfig(**ROUTER_RADIX)] * n,
                         radix, graphs=mode == "graph")
            for mode in ("graph", "eager")}
    for mode, run in runs.items():
        report_router(f"router-radix {mode}", run)
    g = runs["graph"]
    require_same("router-radix", g, runs["eager"])
    router_fleet_checks("router-radix", g, CONT_KERNELS)
    merged = g["router"].global_counters()
    require(merged["prefix_hits"] > 0, "router-radix: no prefix hit")
    log(f"router-radix: graph == eager; prefix_hits {merged['prefix_hits']}"
        f", prefix_routed {merged['prefix_routed']}, migrations_declined "
        f"{merged['migrations_declined']}, placements "
        + ", ".join(f"replica{i} {merged[f'placements_replica{i}']}"
                    for i in range(n))
        + "; launches " + json.dumps(g["launches"]))
    del runs, g

    rng = np.random.default_rng(RESCUE["seed"])
    prompt = rng.integers(0, cfg.vocab_size, size=RESCUE["prompt"]).astype(
        np.int32)
    for kv in ("native", "int8"):
        big = ServeConfig(**dict(SERVE, max_horizon=1, kv_dtype=kv))
        out = rescue_run(model, params, big, RESCUE["small_pages"], prompt,
                         RESCUE["new"])
        wall = out["wall"]
        log(f"router-rescue {kv}: restore_migrations 1, failed_unreachable "
            f"0; record {out['shape']} {out['dtype']} = {out['bytes']} B "
            f"({out['bytes'] / 1e6:.2f} MB) restored bit for bit; export "
            f"{wall['export'] * 1e3:.3f} ms + import "
            f"{wall['import'] * 1e3:.3f} ms + restore "
            f"{wall['restore'] * 1e3:.3f} ms = "
            f"{sum(wall.values()) * 1e3:.3f} ms wall; {len(out['tokens'])} "
            "greedy tokens identical to the lone engine's; decode replays "
            f"{replays_of(out['replays_before'], 'decode')} before the "
            f"restore, {replays_of(out['replays'], 'decode')} after")
        del out
    gc.collect()
    torch.cuda.empty_cache()
    memory_phase(model, params)


class GatherTap:
    """Within ``with``: the executor's continuation gather count is also
    taken with the CUDA-core route's query block (its own method, the
    route rule forced to ``"simt"``), summed in ``simt`` beside the
    counted total in ``counted``."""

    def __enter__(self):
        import repro_torch.serve.executor as X
        self.mod, self.orig = X, X.Executor._continuation_gather_bytes
        self.counted = self.simt = 0
        tap = self

        def counted(ex, *args):
            got = tap.orig(ex, *args)
            rule = X.prefill_route_rule
            X.prefill_route_rule = lambda *a: "simt"
            try:
                tap.simt += tap.orig(ex, *args)
            finally:
                X.prefill_route_rule = rule
            tap.counted += got
            return got

        X.Executor._continuation_gather_bytes = counted
        return self

    def __exit__(self, *exc):
        self.mod.Executor._continuation_gather_bytes = self.orig


class ChunkTap:
    """Wraps ``ops.paged_copy_kv_at`` and remembers the chunk lengths of its
    last call: the continuation attention that follows in the same layer
    runs on those chunks."""

    def __init__(self, fn):
        self.fn, self.lens = fn, None

    def __call__(self, k, v, kp, vp, pt, starts, lens, **kw):
        self.lens = lens
        return self.fn(k, v, kp, vp, pt, starts, lens, **kw)


def attended_pairs(starts, chunks) -> int:
    """(query, key) pairs the continuation attention needs: query ``t`` of
    row ``b`` sees ``starts[b] + t + 1`` keys."""
    return sum(c * (s + 1) + c * (c - 1) // 2
               for s, c in zip(starts, chunks))


#: the ops a cold serve run calls: the copies as pairs (K and V)
COLD_OPS = ("paged_copy_kv", "flash_attention", "paged_decode_attention")


def record_inputs(model, params, cold, int8, cont, cont_int8):
    """Repeat serve runs, untimed, with each ``ops`` wrapper wrapped in a
    :class:`Recorder` (which synchronizes to weigh each call), and return
    the recorders of the bf16 runs, the int8 decode recorder and the int8
    continuation-attention recorder.  Each run is ``(ServeConfig, prefix,
    requests)``: ``cold`` records the copy, flash and decode attention,
    ``int8`` the decode attention over int8 pools, each of ``cont`` the
    continuation copy and attention, ``cont_int8`` the continuation
    attention over int8 pools."""
    from repro_torch.kernels import ops

    def pairs(tap):
        return lambda q, kp, vp, pt, starts, **kw: attended_pairs(
            starts[:q.shape[0]].tolist(), tap.lens[:q.shape[0]].tolist())

    saved = {n: getattr(ops, n) for n in (*COLD_OPS, "paged_copy_kv_at",
                                          "paged_prefill_attention")}
    rec = {
        "paged_copy": Recorder(
            ops.paged_copy_kv,
            lambda k, v, kp, vp, pt, lens, **kw: int(lens.sum())),
        "flash_attention": Recorder(
            ops.flash_attention, lambda q, k, v, **kw: q.numel()),
        "paged_decode_attention": Recorder(
            ops.paged_decode_attention,
            lambda q, kp, vp, pt, sl, **kw: int(sl[:q.shape[0]].sum())),
        "paged_copy_at": Recorder(
            ops.paged_copy_kv_at,
            lambda k, v, kp, vp, pt, st, lens, **kw: int(lens.sum())),
    }
    tap = ChunkTap(rec["paged_copy_at"])
    rec["paged_prefill_attention"] = Recorder(
        ops.paged_prefill_attention, pairs(tap),
        keep=lambda: tap.lens.clone())
    rec_q = Recorder(saved["paged_decode_attention"],
                     rec["paged_decode_attention"].work)
    tap_q = ChunkTap(saved["paged_copy_kv_at"])
    rec_pq = Recorder(saved["paged_prefill_attention"], pairs(tap_q),
                      keep=lambda: tap_q.lens.clone())

    def use(**wrappers):
        """Record through ``wrappers`` only; every other op runs bare."""
        for n, f in saved.items():
            setattr(ops, n, wrappers.get(n, f))

    def serve(scfg, prefix, reqs):
        run_engine(model, params, scfg, reqs, prefix)

    try:
        # each run records only the kernels of its own path, so the cold
        # rows keep the shapes of the cold serve run
        use(paged_copy_kv=rec["paged_copy"],
            **{n: rec[n] for n in COLD_OPS[1:]})
        serve(*cold)
        use(paged_decode_attention=rec_q)
        serve(*int8)
        use(paged_copy_kv_at=tap,
            paged_prefill_attention=rec["paged_prefill_attention"])
        for run in cont:
            serve(*run)
        use(paged_copy_kv_at=tap_q, paged_prefill_attention=rec_pq)
        serve(*cont_int8)
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


def copy_check(best, tag: str = ""):
    """The recorded pair call of a copy (``paged_copy_kv``, or
    ``paged_copy_kv_at`` with ``starts``): the pair launch and the
    single-tensor launch (K alone) bit-identical to the plain versions on
    the whole pools and on the burst route, and ``lens`` all 0 leaving the
    pools untouched.  Returns the copy's name and its pair, single and
    plain calls."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_copy import (
        paged_copy, paged_copy_at, paged_copy_kv, paged_copy_kv_at)
    args, kw = best
    at = len(args) == 7
    k, v, kp, vp, pt = args[:5]
    starts, lens = (args[5], args[6]) if at else (None, args[5])
    page = kw["page_size"]
    name = "paged_copy_at" if at else "paged_copy"
    extra = (starts,) if at else ()

    def pair(kp_, vp_, lens_=lens):
        fn = paged_copy_kv_at if at else paged_copy_kv
        return fn(k, v, kp_, vp_, pt, *extra, lens_, page_size=page)

    def single(kp_):
        fn = paged_copy_at if at else paged_copy
        return fn(k, kp_, pt, *extra, lens, page_size=page)

    def plain(src, pool, lens_=lens):
        fn = ref.paged_copy_at_ref if at else ref.paged_copy_ref
        return fn(src, pool, pt, *extra, lens_, page_size=page)

    ops.reset_launch_counts()
    got = pair(kp.clone(), vp.clone())
    want = (plain(k, kp.clone()), plain(v, vp.clone()))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{tag}{name} pair differs at serve shapes")
    require(torch.equal(single(kp.clone()), want[0]),
            f"{tag}{name} single differs at serve shapes")
    require(all(torch.equal(g, w) for g, w in zip(
        pair(kp.clone(), vp.clone(), torch.zeros_like(lens)), (kp, vp))),
        f"{tag}{name} with lens 0 wrote to the pools")
    require(ops.route_counts()[name] == {"burst": 3, "rows": 0},
            f"{tag}{name}: the recorded calls are off the burst route: "
            f"{ops.route_counts()[name]}")
    return name, pair, single, plain


def copy_rows(best, launches) -> dict:
    """:func:`copy_check` on the recorded pair call of a copy, then the
    device times of the pair (bound: both tensors' rows read and written
    once, the table and the lengths; the library call: two ``index_copy_``
    on the flat pools), of one tensor, and of the floor (the pair launch
    with ``lens`` all 0: every block exits after reading its lengths).
    Prints the single and floor rows and returns the pair's, which the
    kernels line carries."""
    import torch
    name, pair, single, plain = copy_check(best)
    args, kw = best
    at = len(args) == 7
    k, v, kp, vp, pt = args[:5]
    starts, lens = (args[5], args[6]) if at else (None, args[5])
    page = kw["page_size"]
    zero = torch.zeros_like(lens)
    b, s, w = k.shape
    n_tok = int(lens[:b].sum())
    row_bytes = w * k.element_size()
    small = pt.numel() * 4 + b * 4 * (1 + at)      # table, lens, starts
    tok = torch.arange(s, device=k.device)
    pos = tok.expand(b, -1) + (starts[:b, None].long() if at else 0)
    valid = tok[None, :] < lens[:b, None]
    vpn = (pos // page).clamp(max=pt.shape[1] - 1)
    flat_rows = (pt[:b].long().gather(1, vpn) * page + pos % page)[valid]
    flat = (k[valid], v[valid])
    work = (kp.clone(), vp.clone())
    flat_pools = [x.view(-1, w) for x in work]

    def lib_pair():
        for pool_, src_ in zip(flat_pools, flat):
            pool_.index_copy_(0, flat_rows, src_)

    ms = time_ms(lambda: pair(*work))
    plain_ms = time_ms(lambda: (plain(k, work[0]), plain(v, work[1])))
    lib = time_ms(lib_pair)
    ms1 = time_ms(lambda: single(work[0]))
    plain1 = time_ms(lambda: plain(k, work[0]))
    lib1 = time_ms(lambda: flat_pools[0].index_copy_(0, flat_rows, flat[0]))
    floor = time_ms(lambda: pair(*work, zero))
    b2, by2 = bound(2 * 2 * n_tok * row_bytes + small, 0)
    b1, by1 = bound(2 * n_tok * row_bytes + small, 0)
    bf, byf = bound(small, 0)
    shape = (f"src {list(k.shape)} {k.dtype}, pool {list(kp.shape)}, "
             f"{n_tok} tokens" + (f" at starts {starts[:b].tolist()}"
                                  if at else ""))
    peak = float(k.float().abs().max())
    print_rows([
        dict(name=f"{name}_single", shape=f"K only: {shape}",
             max_abs_err=0.0, max_abs_want=peak, ms=ms1, plain_ms=plain1,
             bound_ms=b1, bound_by=by1, library_ms=lib1,
             library="index_copy_ on the flat pool", launches=None),
        dict(name=f"{name}_floor", shape=f"K and V, lens all 0: {shape}",
             max_abs_err=0.0, max_abs_want=0.0, ms=floor, plain_ms=0.0,
             bound_ms=bf, bound_by=byf, library_ms=None, library=None,
             launches=None)])
    log(f"kernel {name}: pair {ms:.5f} ms, single {ms1:.5f} ms, floor "
        f"{floor:.5f} ms; pair - floor {ms - floor:.5f} ms = "
        f"{(ms - floor) / b2:.2f}x its bound {b2:.5f} ms; single - floor "
        f"{ms1 - floor:.5f} ms = {(ms1 - floor) / b1:.2f}x its bound "
        f"{b1:.5f} ms; two index_copy_ {lib:.5f} ms")
    return dict(name=name, shape=f"K and V in one launch: {shape}",
                max_abs_err=0.0, max_abs_want=peak, ms=ms, plain_ms=plain_ms,
                bound_ms=b2, bound_by=by2, library_ms=lib,
                library="two index_copy_ on the flat pools (K, V)",
                launches=launches)


def flash_check(best, tag: str = "flash_attention"):
    """The recorded ``flash_attention`` call on its tensor-core route,
    row by row against its plain version (:func:`bf16_rows_check`)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    (q, k, v), _ = best
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    require(ops.route_counts()["flash_attention"]["wgmma"] == 1,
            f"{tag}: the recorded call is off the tensor-core route")
    return bf16_rows_check(tag, got,
                           ref.flash_attention_ref(q, k, v, causal=True))


def decode_check(tag, best):
    """The recorded ``paged_decode_attention`` call on its tensor-core
    route, row by row against its plain version."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    (q, kp, vp, pt, sl), kw = best
    kw = dict(kw)
    kw.pop("use_kernel", None)
    ops.reset_launch_counts()
    got = paged_decode_attention(q, kp, vp, pt, sl, **kw)
    require(ops.route_counts()["paged_decode_attention"]["mma"] == 1,
            f"{tag}: the recorded call is off the tensor-core route")
    want = ref.paged_decode_attention_ref(q, kp, vp, pt, sl, **kw)
    return bf16_rows_check(tag, got, want)


def prefill_check(tag, recorder):
    """The recorded ``paged_prefill_attention`` call on its tensor-core
    route against its plain version: each real row (token, head) of each
    sequence's chunk within four bf16 steps of its own largest output."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    (q, kp, vp, pt, starts), kw = recorder.best
    kw = dict(kw)
    kw.pop("use_kernel", None)
    chunks = recorder.extra[:q.shape[0]].tolist()
    ops.reset_launch_counts()
    got = paged_prefill_attention(q, kp, vp, pt, starts, **kw)
    require(ops.route_counts()["paged_prefill_attention"]["wgmma"] == 1,
            f"{tag}: the recorded call is off the tensor-core route")
    want = ref.paged_prefill_attention_ref(q, kp, vp, pt, starts, **kw)
    checked = [bf16_rows_check(f"{tag} row {i}", got[i, :c], want[i, :c])
               for i, c in enumerate(chunks) if c]
    return max(e for e, _ in checked), max(p for _, p in checked)


def attention_checks(tag, rec, rec_q, rec_pq) -> None:
    """Each copy and attention kernel against its plain version on the
    inputs :func:`record_inputs` kept, untimed: the copies bit-identical
    (:func:`copy_check`), the attention kernels within the tolerance of
    :func:`full_checks`, every call on its Hopper route."""
    copy_check(rec["paged_copy"].best, f"{tag} ")
    copy_check(rec["paged_copy_at"].best, f"{tag} ")
    errs = {
        "flash_attention": flash_check(rec["flash_attention"].best,
                                       f"{tag} flash_attention"),
        "paged_decode_attention": decode_check(
            f"{tag} paged_decode_attention",
            rec["paged_decode_attention"].best),
        "paged_decode_attention_int8": decode_check(
            f"{tag} paged_decode_attention_int8", rec_q.best),
        "paged_prefill_attention": prefill_check(
            f"{tag} paged_prefill_attention",
            rec["paged_prefill_attention"]),
        "paged_prefill_attention_int8": prefill_check(
            f"{tag} paged_prefill_attention_int8", rec_pq),
    }
    # the first three operands of each checked call, the third's dtype
    # (the pool's, or v's for flash)
    shapes = {n: " ".join(str(list(x.shape)) for x in r.best[0][:3])
              + f" {r.best[0][2].dtype}" for n, r in (
        ("paged_copy", rec["paged_copy"]),
        ("paged_copy_at", rec["paged_copy_at"]),
        ("flash_attention", rec["flash_attention"]),
        ("paged_decode_attention", rec["paged_decode_attention"]),
        ("paged_decode_attention_int8", rec_q),
        ("paged_prefill_attention", rec["paged_prefill_attention"]),
        ("paged_prefill_attention_int8", rec_pq))}
    log(f"check {tag}: paged_copy and paged_copy_at (pair and single) "
        f"bit-identical to their plain versions on the burst route; "
        + "; ".join(f"{n} within four bf16 steps of each row's peak (|err| "
                    f"{e:.3g}, max|want| {p:.3g})" for n, (e, p) in
                    errs.items())
        + "; operands checked " + json.dumps(shapes))


def full_checks(rec, rec_q, launches, launches_q) -> list[dict]:
    """Kernel vs plain version on the recorded serve inputs, then timings.
    bf16 attention tolerance: four bf16 steps of the largest output,
    ``4 * 2**-8 * max|want|``.  Both sides take the same bf16 inputs and
    sum in f32 in different orders, and round once to bf16 (one step is
    at most ``2**-8`` relative), so a right kernel differs by about one
    step; a dropped page or head moves outputs by far more."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    rows = []

    # paged_copy — the pair launch, one tensor and the floor
    rows.append(copy_rows(rec["paged_copy"].best, launches["paged_copy"]))

    # flash attention
    (q, k, v), kw = rec["flash_attention"].best
    err, peak = flash_check(rec["flash_attention"].best)
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
    print_rows([flash_long_row()])

    # paged decode attention (bf16 pools, then int8 pools)
    rows.append(decode_row("paged_decode_attention",
                           rec["paged_decode_attention"].best,
                           launches["paged_decode_attention"]))
    rows.append(decode_row("paged_decode_attention_int8", rec_q.best,
                           launches_q["paged_decode_attention"]))
    print_rows(rows)
    return rows


def decode_row(tag, best, n_launch) -> dict:
    """:func:`decode_check` on a recorded ``paged_decode_attention`` call,
    then the device times of kernel and plain version beside the bound:
    each cached token's K and V once, q read and the output written once,
    the lengths and the page-table entries."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    err, peak = decode_check(tag, best)
    (q, kp, vp, pt, sl), kw = best
    kw = dict(kw)
    kw.pop("use_kernel", None)
    bsz, hkv, g, d = q.shape
    n_tok = int(sl[:bsz].sum())
    flops = 4.0 * g * d * hkv * n_tok
    n_pages = int(((sl[:bsz] + kw["page_size"] - 1)
                   // kw["page_size"]).sum())
    kv_tok = 2 * hkv * d * kp.element_size()       # one token, K + V
    nbytes = (n_tok * kv_tok
              + 2 * q.numel() * q.element_size() + bsz * 4 + n_pages * 4)
    # the tensor-core route copies the rows [lo, len) of each sequence
    # and nothing past len; lo = 0 without a window
    fetched = n_tok * kv_tok
    ms = time_ms(lambda: paged_decode_attention(q, kp, vp, pt, sl, **kw))
    plain = time_ms(lambda: ref.paged_decode_attention_ref(
        q, kp, vp, pt, sl, **kw))
    b_ms, b_by = bound(nbytes, flops)
    return dict(name=tag, shape=f"q {list(q.shape)} {q.dtype}, "
                f"pool {list(kp.shape)} {kp.dtype}, {n_tok} cached "
                f"tokens; kernel fetches {fetched} B of K/V, the "
                f"bound counts {n_tok * kv_tok} B",
                max_abs_err=err, max_abs_want=peak,
                ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library=None, launches=n_launch)


#: a 4,096-token qwen2-7b prefill: the shape where the tensor cores, not
#: launch latency, set flash_attention's time
FLASH_LONG = (1, 4096, 28, 4, 128)


def flash_long_row() -> dict:
    """``flash_attention`` at :data:`FLASH_LONG` (the serve path's
    transposed views, random bf16 from a seed) against its plain version
    row by row, timed beside SDPA.  No path launches this shape, so the
    row is printed but stays off the kernels line (``launches`` None)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    b, s, hq, hkv, d = FLASH_LONG
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
               .bfloat16().transpose(1, 2) for h in (hq, hkv, hkv))
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    require(ops.route_counts()["flash_attention"]["wgmma"] == 1,
            "4096-token flash_attention off the tensor-core route")
    err, peak = bf16_rows_check("flash_attention 4096", got,
                                ref.flash_attention_ref(q, k, v,
                                                        causal=True))
    del got
    flops = 4.0 * b * hq * d * s * (s + 1) / 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), n=20, reps=3)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True),
                    n=5, reps=3)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), n=20, reps=3)
    b_ms, b_by = bound(nbytes, flops)
    return dict(name="flash_attention_4096", shape=f"q {list(q.shape)} "
                f"k {list(k.shape)} {q.dtype} (a 4,096-token prefill)",
                max_abs_err=err, max_abs_want=peak, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library="F.scaled_dot_product_attention(is_causal, "
                "enable_gqa)", launches=None)


def continuation_checks(rec, rec_pq, counts) -> list[dict]:
    """The continuation kernels against their plain versions on the
    recorded inputs of the continuation runs, then their timings; the same
    tolerances as :func:`full_checks`.  The bound counts each input once:
    q, the output, and each row's key/value pages up to its last real
    query, once (the kernel fetches a page once per query block; it prints
    those bytes too)."""
    rows = []
    served = {k: counts["radix"][k] + counts["fork"][k]
              for k in CONT_KERNELS}

    # paged_copy_at — the pair launch, one tensor and the floor
    rows.append(copy_rows(rec["paged_copy_at"].best,
                          served["paged_copy_at"]))

    # paged_prefill_attention (bf16 pools, then int8 pools)
    rows.append(prefill_row("paged_prefill_attention",
                            rec["paged_prefill_attention"],
                            served["paged_prefill_attention"]))
    rows.append(prefill_row("paged_prefill_attention_int8", rec_pq,
                            counts["radix int8"]["paged_prefill_attention"]))
    print_rows(rows)
    return rows


def prefill_row(tag, r, n_launch) -> dict:
    """:func:`prefill_check` on a recorded ``paged_prefill_attention``
    call (a :class:`Recorder` that kept the chunk lengths), then the
    device times of kernel and plain version beside the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention,
        pages_touched,
        prefill_route,
        query_block,
    )
    err, peak = prefill_check(tag, r)
    (q, kp, vp, pt, starts), kw = r.best
    kw = dict(kw)
    kw.pop("use_kernel", None)
    page = kw["page_size"]
    b, s, hkv, g, d = q.shape
    chunks = r.extra[:b].tolist()
    st = starts[:b].tolist()
    max_pages = pt.shape[1]
    kv_row = page * hkv * d * 2 * kp.element_size()   # one page, K + V
    needed = sum(min(-(-(x + c) // page), max_pages)
                 for x, c in zip(st, chunks))
    route = prefill_route(q, kp, vp, page)
    fetched = sum(pages_touched(x, s, max_pages, page_size=page,
                                bq=query_block(g, route)) for x in st)
    fetched_simt = sum(pages_touched(x, s, max_pages, page_size=page,
                                     bq=query_block(g, "simt"))
                       for x in st)
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
    return dict(name=tag, shape=f"q {list(q.shape)} {q.dtype}, "
                f"pool {list(kp.shape)} {kp.dtype}, starts {st}, "
                f"chunks {chunks}; kernel fetches "
                f"{fetched * kv_row} B of K/V (bq "
                f"{query_block(g, route)}; {fetched_simt * kv_row} B "
                f"at the CUDA-core bq {query_block(g, 'simt')}), "
                f"the bound counts {needed * kv_row} B",
                max_abs_err=err,
                max_abs_want=peak, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library=None, launches=n_launch)


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
    for name in ("wkv6", "wkv6_chunked"):
        ms, count, share = kernel_share(prof, f"{name}_kernel<")
        log(f"rwkv profile ({model.tm_impl}), prefill: {name} {ms:.2f} ms "
            f"over {count} launches, {share:.1f}% of device time")
    if not steps:
        return
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rwkv_decode(model, params, logits, st, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"rwkv profile ({model.tm_impl}), {steps} decode steps:")
    print_profile(prof, wall, top=8)


def kernel_share(prof, *needles: str) -> tuple[float, int, float]:
    """Device milliseconds, launches and percent of all device time of the
    traced kernels whose name holds one of ``needles``."""
    from torch.autograd import DeviceType
    from repro_torch.launch.serve import _device_us
    rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    busy = sum(_device_us(e) for e in rows)
    mine = [e for e in rows if any(n in e.key for n in needles)]
    us = sum(_device_us(e) for e in mine)
    return us / 1e3, sum(e.count for e in mine), 100 * us / max(busy, 1e-9)


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
    routes = ops.route_counts()["paged_gather"]
    cpu = lines("cpu")
    require(card == cpu, f"quickstart: the card printed {card}, the CPU {cpu}")
    want = {"paged_copy": 1, "paged_gather": 1}
    require(launches == {**dict.fromkeys(launches, 0), **want},
            f"quickstart launches {launches}, expected {want}")
    # the quickstart's pool rows are 4 f32 (16 bytes): narrow, so lanes
    require(routes == {"bulk": 0, "lanes": 1},
            f"quickstart paged_gather routes {routes}, expected lanes 1")
    for line in card:
        log(f"quickstart | {line}")
    log("quickstart: card == cpu, line for line; launches "
        + json.dumps({k: launches[k] for k in want})
        + f"; paged_gather routes {json.dumps(routes)}")
    return launches


#: one layer of qwen2-7b's K pool (Hkv 4 x head_dim 128 = 512, bf16, page
#: 16, 2,304 frames) and a 32,768-token sequence (2,048 pages)
GATHER = dict(page=16, frames=2304, tokens=32768, w=512)

#: a pool larger than the H100's 50 MB L2 (9,216 frames of 16 KB, 151 MB)
#: holding a 131,072-token sequence, read at 32,768 random positions
GATHER_BIG = dict(page=16, frames=9216, tokens=131072, w=512, n=32768)

#: batches of a gather and of ``index_select``, each timed in turns, for
#: the spread of both
GATHER_BATCHES = 11


def gather_streams(tokens: int, n: int | None = None) -> dict:
    """The four streams of ``benchmarks/bench_translation.py`` over a
    ``tokens``-token sequence; the random ones draw ``n`` (default
    ``tokens``) positions."""
    import numpy as np
    n = tokens if n is None else n
    srng = np.random.default_rng(0)
    return {
        "unit_stride": np.arange(tokens),
        "strided_4": np.arange(0, tokens, 4),
        "random": srng.integers(0, tokens, size=n),
        "sorted_random": np.sort(srng.integers(0, tokens, size=n)),
    }


def gather_pool(frames: int, page: int, w: int, seed: int = 8):
    """A seeded bf16 pool ``[frames, page, w]`` on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((frames, page, w), generator=gen,
                       device="cuda").to(torch.bfloat16)


def gather_bound(pool, row, p, page: int) -> tuple[int, float, str]:
    """The bytes a gather of ``p`` must move, and its bound: each distinct
    pool row and table entry read once, the positions read once, every
    output row written once."""
    import torch
    w, isz = pool.shape[2], pool.element_size()
    n = p.numel()
    vpn = (p.long() // page).clamp(max=row.numel() - 1)
    nbytes = ((torch.unique(p).numel() + n) * w * isz + 4 * n
              + 4 * torch.unique(vpn).numel())
    return (nbytes, *bound(nbytes, 0))


def spread_verdict(k_ms, l_ms) -> str:
    return ("behind the call beyond the spread" if min(k_ms) > max(l_ms)
            else "ahead of the call beyond the spread" if max(k_ms) < min(l_ms)
            else "level with the call within the spread")


def gather_pair(tag: str, pool, row, p, page: int, *,
                fill: str = "write") -> tuple[float, float]:
    """The kernel and ``index_select`` on precomputed rows, timed in
    :data:`GATHER_BATCHES` paired batches of 50 calls; logs each batch,
    both medians and spreads, the verdict and the kernel's share of the
    bound.  Returns the two medians."""
    from repro_torch.kernels.paged_gather import paged_gather
    w = pool.shape[2]
    vpn = (p.long() // page).clamp(max=row.numel() - 1)
    flat_rows = (row.long()[vpn].clamp(min=0, max=pool.shape[0] - 1) * page
                 + p.long() % page)
    flat = pool.view(-1, w)
    k_ms, l_ms = paired_batches(
        (lambda: paged_gather(pool, row, p, page_size=page),
         lambda: flat.index_select(0, flat_rows)),
        reps=GATHER_BATCHES, fill=fill)
    ms, lib = statistics.median(k_ms), statistics.median(l_ms)
    nbytes, b_ms, _ = gather_bound(pool, row, p, page)
    log(f"{tag} ({fill}-filled L2): per-batch ms (50 calls a batch, taken "
        f"in turns), kernel {' '.join(f'{t:.5f}' for t in k_ms)}; "
        f"index_select {' '.join(f'{t:.5f}' for t in l_ms)}; kernel median "
        f"{ms:.5f} spread {min(k_ms):.5f}-{max(k_ms):.5f}, index_select "
        f"median {lib:.5f} spread {min(l_ms):.5f}-{max(l_ms):.5f}; bound "
        f"{b_ms:.5f} ms ({nbytes} B), kernel at {100 * b_ms / ms:.1f} % of "
        f"it, index_select at {100 * b_ms / lib:.1f} %: the kernel is "
        + spread_verdict(k_ms, l_ms) + f" [{CARD}]")
    return ms, lib


def gather_phase(launches) -> list[dict]:
    """Map the sequence in scrambled frames, gather the four streams of
    ``benchmarks/bench_translation.py`` at 32,768 tokens through the
    kernel, the plain version and the coalesced route (bit-identical, the
    kernel on its ``"bulk"`` route), print each stream's translation
    counts and 16-entry DTLB reports, and time each stream beside
    ``index_select`` on precomputed rows (:func:`gather_pair`, each with
    its own bound: each distinct pool row and table entry read once,
    every output row written once, the positions read once); the random
    stream again with a read-filled L2; then a pool larger than the L2
    (:data:`GATHER_BIG`, printed, off the kernels line)."""
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
    pool = gather_pool(frames, page, w)
    log(f"gather: pool {list(pool.shape)} bf16 ({pool.numel() * 2 / 1e6:.1f} "
        f"MB, one layer of qwen2-7b's K pool), {tokens} tokens in {len(seq.pages)} "
        f"frames ({adjacent} of {len(seq.pages) - 1} neighbours in adjacent "
        f"frames after {decoys} decoys)")
    streams = gather_streams(tokens)
    dev_streams = {}
    for name, pos in streams.items():
        p = torch.as_tensor(pos.astype(np.int32), device=dev)
        dev_streams[name] = p
        before = dict(paged_gather.routes)
        got = paged_gather(pool, row, p, page_size=page)
        routes = {r: paged_gather.routes[r] - before[r] for r in before}
        require(routes == {"bulk": 1, "lanes": 0},
                f"gather {name}: paged_gather routes {routes}, expected "
                "bulk 1")
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
    ms, lib = {name: gather_pair(f"gather {name}", pool, row, p, page)
               for name, p in dev_streams.items()}["random"]
    p = dev_streams["random"]
    gather_pair("gather random", pool, row, p, page, fill="read")
    plain = time_ms(lambda: ref.paged_gather_ref(pool, row, p,
                                                 page_size=page))
    coal_ms = time_ms(lambda: ops.paged_gather_coalesced(pool, row, p,
                                                         page_size=page))
    n = p.numel()
    nbytes, b_ms, b_by = gather_bound(pool, row, p, page)
    log(f"gather random: coalesced route {coal_ms:.4f} ms; the bound counts "
        f"{torch.unique(p).numel()} distinct rows of {n} ({nbytes} B; "
        f"every row read would be {2 * n * w * 2 + 8 * n} B, "
        f"{bound(2 * n * w * 2 + 8 * n, 0)[0]:.4f} ms)")
    big = gather_big()
    log(f"gather beyond the L2: {big}")
    return [dict(name="paged_gather", shape=f"pool {list(pool.shape)} bf16, "
                 f"{n} random positions with repeats", max_abs_err=0.0,
                 max_abs_want=float(pool.float().abs().max()), ms=ms,
                 plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                 library_ms=lib, library="index_select on precomputed rows",
                 launches=launches["paged_gather"])]


def gather_big() -> str:
    """:data:`GATHER_BIG`: the sequence in a random permutation of the
    frames, the random stream gathered bit-identical to the plain version
    and timed beside ``index_select`` (dirty and read-filled L2).  Whether
    translation costs more once the rows are not L2-resident."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_gather import paged_gather
    page, frames, tokens, w, n = (GATHER_BIG[k] for k in (
        "page", "frames", "tokens", "w", "n"))
    row = torch.as_tensor(np.random.default_rng(7).permutation(frames)[
        :tokens // page].astype(np.int32), device="cuda")
    pool = gather_pool(frames, page, w, seed=10)
    p = torch.as_tensor(gather_streams(tokens, n)["random"].astype(np.int32),
                        device="cuda")
    require(torch.equal(paged_gather(pool, row, p, page_size=page),
                        ref.paged_gather_ref(pool, row, p, page_size=page)),
            "gather beyond the L2: kernel and plain version differ")
    tag = (f"gather beyond the L2, pool {list(pool.shape)} bf16 "
           f"({pool.numel() * 2 / 1e6:.1f} MB), {tokens} tokens, {n} random "
           "positions")
    dirty = gather_pair(tag, pool, row, p, page)
    clean = gather_pair(tag, pool, row, p, page, fill="read")
    _, b_ms, _ = gather_bound(pool, row, p, page)
    return (f"bit-identical; kernel {dirty[0]:.5f} / {clean[0]:.5f} ms "
            f"(dirty / read-filled L2), index_select {dirty[1]:.5f} / "
            f"{clean[1]:.5f}, bound {b_ms:.5f} [{CARD}]")


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
    routes = ops.route_counts()["matmul"]
    require(routes == {"wgmma": 1, "simt": 3},
            f"matmul routes {routes}: the f32 products take the CUDA cores, "
            "the gate projection wgmma")
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
        f"launches {launches['matmul']}, routes {routes}")
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
    matmul_tile_times()
    return rows


#: f32 products on each side of the CUDA-core tile choice, with and
#: without 16-byte copies (K not a multiple of 4)
TILE_SHAPES = ((181, 181, 181), (384, 384, 384), (384, 383, 384),
               (1024, 1024, 1024), (1024, 1022, 1024), (1536, 1536, 1536),
               (1536, 1534, 1536))


def matmul_tile_times() -> None:
    """The CUDA-core ``matmul`` in f32 at :data:`TILE_SHAPES`, launched at
    every tile size (the C launcher called directly, so no launch counts)
    beside ``torch.matmul`` f32: whether :func:`simt_config`'s choice is
    the fastest tile.  Each forced tile is checked within 1e-4 of the
    largest output before it is timed."""
    import torch
    from repro_torch.kernels import build as B
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import SIMT_TILES, simt_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = B.launcher("matmul")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m, k, n in TILE_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev)
        y = torch.randn((k, n), generator=gen, device=dev)
        out = torch.empty((m, n), device=dev)
        chosen, vec = simt_config(x, y, sms)
        want = ref.matmul_ref(x, y)

        def forced(tile):
            B.check(fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                       k, n, n, 0, 0, 0, tile, int(vec), stream), "matmul")
        times = {}
        for tile in SIMT_TILES:
            forced(tile)
            matmul_err(f"matmul f32 [{m},{k},{n}] tile {tile}", out, want,
                       1e-4)
            times[tile] = time_ms(lambda: forced(tile), n=20, reps=3)
        lib = time_ms(lambda: torch.matmul(x, y), n=20, reps=3)
        best = min(times, key=times.get)
        log(f"matmul f32 tiles [{m},{k}]x[{k},{n}] vec {vec}: "
            + ", ".join(f"{t}: {times[t]:.4f} ms" for t in SIMT_TILES)
            + f"; chosen {chosen} ({times[chosen]:.4f} ms), fastest {best}; "
            f"torch.matmul f32 {lib:.4f} ms")


# ---------------------------------------------------------------------------
# the MoE family: granite-moe-1b-a400m, and llama4's interleaved layout
# ---------------------------------------------------------------------------

MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")


def reduced_moe_check() -> None:
    """``ragged_dot`` against its plain version at reduced f32 shapes (the
    CUDA-core route: empty groups, one group holding every row, rows past
    the last group) and in bf16 on both tensor-core routes (``"mma"``,
    ``"wgmma"``), then reduced granite-moe and llama4 (f32, 2 layers;
    llama4 routes in layer 1 only) engines on the card against the same
    engines and weights on the CPU: cold (preemption), int8 pools and the
    default policy (radix hits, partial restores) with identical greedy
    tokens and every counter (less ``prefill_bytes_gathered``, which counts
    by route), ``ragged_dot`` launched on its CUDA-core route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for m, k, n, sizes in ((24, 64, 64, [10, 0, 14, 0]),
                           (24, 64, 64, [0, 24, 0, 0]),
                           (40, 64, 128, [3, 0, 0, 5, 9, 0, 1, 2]),
                           (7, 128, 64, [7, 0, 0, 0, 0, 0, 0, 0])):
        xs = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((len(sizes), k, n), generator=gen, device="cuda")
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        got, want = ops.ragged_dot(xs, w, gs), ref.ragged_dot_ref(xs, w, gs)
        err = close_err(got, want, 1e-5)
        require(not got[sum(sizes):].any(),
                "ragged_dot: rows past the last group are not zero")
        worst = max(worst, err)
    log(f"check reduced: ragged_dot f32 (simt) with empty groups, one group "
        f"holding every row and rows past the last group within 1e-5 of "
        f"the largest output (largest |err| {worst:.3g})")
    from repro_torch.kernels.ragged_dot import ragged_route
    for m, k, n, sizes, route in (
            (70, 64, 72, [10, 0, 50, 0], "mma"),
            (40, 128, 64, [3, 0, 0, 5, 9, 0, 20, 2], "mma"),
            (600, 64, 136, [100, 300, 0, 150], "wgmma"),
            (300, 192, 256, [0, 0, 300, 0], "wgmma")):
        xs = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((len(sizes), k, n), generator=gen, device="cuda")
             / k ** 0.5).bfloat16()
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        require(ragged_route(xs, w) == route,
                f"ragged_dot: route {ragged_route(xs, w)} at M = {m}")
        ops.reset_launch_counts()
        got, again = ops.ragged_dot(xs, w, gs), ops.ragged_dot(xs, w, gs)
        require(ops.route_counts()["ragged_dot"][route] == 2,
                f"ragged_dot: off its {route} route")
        bf16_rows_check(f"ragged_dot {route} M {m}", got,
                        ref.ragged_dot_ref(xs, w, gs))
        require(torch.equal(got, again) and not got[sum(sizes):].any(),
                f"ragged_dot {route} M {m}: two launches differ, or rows "
                "past the last group are not zero")
    log("check reduced: ragged_dot bf16 on mma and wgmma (groups ending "
        "inside a tile, N not a multiple of the tile, rows past the last "
        "group) within four bf16 steps of each row's peak, bit-identical "
        "twice")
    for arch in MOE_ARCHS:
        cfg = get_config(arch, reduced=True)
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(0)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = to_device(cpu_params, "cuda")
        cold = dict(page_size=4, num_pages=16, max_pages_per_seq=16,
                    max_batch=3, prefix_cache=False, restore_patience=0)
        cases = (
            ("cold", ServeConfig(**cold), serve_workload(
                cfg.vocab_size, n=7, lo=4, hi=13, max_new=12, seed=13)),
            ("int8", ServeConfig(**cold, kv_dtype="int8"), serve_workload(
                cfg.vocab_size, n=7, lo=4, hi=13, max_new=12, seed=13)),
            ("default policy", ServeConfig(
                page_size=4, num_pages=16, max_pages_per_seq=16,
                max_batch=3), reduced_radix_workload(cfg.vocab_size)),
        )
        for tag, scfg, reqs in cases:
            ops.reset_launch_counts()
            e_gpu, r_gpu, _ = run_engine(gpu_model, gpu_params, scfg, reqs)
            launches, routes = ops.launch_counts(), ops.route_counts()
            e_cpu, r_cpu, _ = run_engine(cpu_model, cpu_params, scfg, reqs)
            c_cpu = dict(e_cpu.counters.counters)
            c_gpu = dict(e_gpu.counters.counters)
            for c in (c_cpu, c_gpu):
                c.pop("prefill_bytes_gathered", None)
            diff = {k: (c_cpu.get(k), c_gpu.get(k))
                    for k in set(c_cpu) | set(c_gpu)
                    if c_cpu.get(k) != c_gpu.get(k)}
            require(not diff, f"reduced {arch} ({tag}) counters differ card "
                              f"vs cpu: {diff}")
            require(all(r_cpu[i].tokens == r_gpu[i].tokens for i in r_cpu),
                    f"reduced {arch} ({tag}) tokens differ card vs cpu")
            require(launches["ragged_dot"] > 0
                    and routes["ragged_dot"]["simt"] == launches["ragged_dot"],
                    f"reduced {arch} ({tag}): ragged_dot launches "
                    f"{launches['ragged_dot']}, routes {routes['ragged_dot']}")
            if tag == "default policy":
                require(c_gpu.get("prefix_hits", 0) > 0,
                        f"reduced {arch}: no prefix hit")
            log(f"check reduced {arch} engine ({tag}): card == cpu greedy "
                f"tokens and all counters; preemptions "
                f"{c_gpu.get('preemptions', 0)}, prefix_hits "
                f"{c_gpu.get('prefix_hits', 0)}, partial_restores "
                f"{c_gpu.get('partial_restores', 0)}; ragged_dot "
                f"{launches['ragged_dot']} launches (simt)")


class DispatchTap:
    """Within ``with``: counts the MoE dispatches of each kind (calls of
    ``moe_apply_ragged`` and ``moe_apply_sorted_rows`` by the model), the
    largest token count each saw, and the ``ragged_dot`` launches that
    ``ragged_route`` implies for the ragged ones (three a dispatch, on the
    route of its ``[tokens x k, d_model]`` rows).  A graph replay calls no
    Python, so only eager runs (and captures) are seen."""

    NAMES = ("moe_apply_ragged", "moe_apply_sorted_rows")

    def __enter__(self):
        from repro_torch.kernels.ragged_dot import ROUTES
        from repro_torch.models import moe
        self.mod, self.calls = moe, dict.fromkeys(self.NAMES, 0)
        self.tokens = dict.fromkeys(self.NAMES, 0)
        self.routes = dict.fromkeys(ROUTES, 0)
        self.saved = {n: getattr(moe, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            setattr(moe, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        import torch
        from repro_torch.kernels.ragged_dot import ragged_route

        def counted(p, x, **kw):
            self.calls[name] += 1
            tokens = x.numel() // x.shape[-1]
            self.tokens[name] = max(self.tokens[name], tokens)
            if name == "moe_apply_ragged":
                rows = torch.empty((tokens * kw["k"], x.shape[-1]),
                                   dtype=x.dtype, device="meta")
                self.routes[ragged_route(rows, p["w_up"])] += 3
            return fn(p, x, **kw)
        return counted

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


#: granite-moe's cold run: 8 prompts of 256-640 tokens, 32 new, page 16,
#: horizon 8, 4 lanes, 130 frames (1 scratch).  A CPU run of the schedule
#: (it depends on lengths only) with the reduced model: one admission
#: batches 4 prompts padded to 640 tokens, 2,560 tokens in one prefill (the
#: per-row sorted dispatch), the others prefill at most 832 tokens and every
#: decode step is ragged; one preemption
MOE_SERVE = dict(page_size=16, num_pages=130, max_pages_per_seq=48,
                 max_batch=4, max_horizon=8, prefix_cache=False,
                 restore_patience=0)
MOE_WORKLOAD = dict(n=8, lo=256, hi=640, max_new=32, seed=0)
#: the MoE path's kernels on the cold run
MOE_KERNELS = COLD_KERNELS + ("ragged_dot",)
#: the device functions of ``ragged_dot``'s routes (``csrc/ragged_dot.cu``)
RAGGED_KERNELS = ("ragged_mma_kernel", "ragged_wgmma_kernel",
                  "ragged_simt_kernel")


def moe_full_model():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("granite-moe-1b-a400m")   # all 24 layers: depth not cut
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for blk in params["blocks"]
                   for sub in blk.values() for t in sub.values()) + sum(
        params[k].numel() for k in ("embed", "head", "ln_f") if k in params
        and hasattr(params[k], "numel"))
    log(f"moe: granite-moe-1b-a400m full width ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} "
        f"kv of {cfg.head_dim}, {cfg.num_experts} experts top-"
        f"{cfg.experts_per_token} of d_ff {cfg.moe_d_ff}, vocab "
        f"{cfg.vocab_size}, bf16, ~{n_params / 1e9:.2f} B parameters) "
        f"initialised on the card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    return cfg, model, params


def moe_runs(cfg):
    """``(tag, ServeConfig, prefix, requests)`` of the MoE serve phase:
    cold (with the > 2,048-token prefill), int8, radix."""
    from repro_torch.serve import ServeConfig
    scfg = ServeConfig(**MOE_SERVE)
    return (("moe cold", scfg, None,
             serve_workload(cfg.vocab_size, **MOE_WORKLOAD)),
            ("moe int8", dataclasses.replace(scfg, kv_dtype="int8"), None,
             serve_workload(cfg.vocab_size, **SHORT)),
            ("moe radix", ServeConfig(**CONT), None,
             radix_workload(cfg.vocab_size)))


def moe_serve_phase(cfg, model, params) -> tuple[dict, dict]:
    """granite-moe-1b-a400m at full width through the engine: the cold,
    int8 and radix runs each with CUDA graphs and inside
    ``disable_graphs()``, identical in greedy tokens, counters, switch
    stats, kernel launches and routes; every kernel of the path launched
    (``ragged_dot`` on its tensor-core route, the paged attention kernels
    and copies on theirs); both MoE dispatches counted in the eager cold
    run; ``ragged_dot``'s launches per route in the eager run equal what
    ``ragged_route`` implies for its ragged dispatches (decode on
    ``"mma"``, prefills of 128 tokens and more on ``"wgmma"``).  Then the
    cold run traced, graphs and eager.  Returns the launch counts and the
    route counts of the cold graph run (the main path)."""
    main = None
    for tag, scfg, prefix, reqs in moe_runs(cfg):
        runs = {}
        for mode in ("graph", "eager"):
            with DispatchTap() as tap:
                runs[mode] = served(model, params, scfg, reqs, prefix,
                                    graphs=mode == "graph")
            runs[mode]["dispatch"] = (dict(tap.calls), dict(tap.tokens),
                                      dict(tap.routes))
        for mode, r in runs.items():
            report(f"{tag} {mode}", r["eng"], r["res"], r["dt"], CONT_KEYS)
            log(f"{tag} {mode}: engine built in {r['build']:.2f}s")
        g, e = runs["graph"], runs["eager"]
        require_same(tag, g, e)
        require(replays_of(g["replays"], "decode", "decode_multi") > 0
                and e["replays"] == {},
                f"{tag}: no decode replay in the graph run, or a replay in "
                "the eager run")
        require_tensor_core_routes(tag, g["launches"])
        for n in MOE_KERNELS if tag != "moe radix" else (
                CONT_KERNELS + ("ragged_dot",)):
            require(g["launches"][n] > 0, f"{tag}: {n} never launched")
        calls, tokens, implied = e["dispatch"]
        require(e["routes"]["ragged_dot"] == implied
                and implied["mma"] > 0 and implied["simt"] == 0
                and (implied["wgmma"] > 0 or tag == "moe radix"),
                f"{tag}: ragged_dot launches by route "
                f"{e['routes']['ragged_dot']}, the route rule implies "
                f"{implied}")
        require(all(r.status == "done" for r in g["res"].values())
                and all(len(r.tokens) == reqs[0].max_new_tokens
                        and all(0 <= t < cfg.vocab_size for t in r.tokens)
                        for r in g["res"].values()),
                f"{tag}: a request did not finish, or a token is outside "
                "the vocabulary")
        log(f"{tag}: graph == eager in greedy tokens, counters, switch "
            f"stats, launches and routes; MoE dispatches in the eager run: "
            f"ragged {calls['moe_apply_ragged']} (largest "
            f"{tokens['moe_apply_ragged']} tokens), sorted rows "
            f"{calls['moe_apply_sorted_rows']} (largest "
            f"{tokens['moe_apply_sorted_rows']} tokens); launches "
            + json.dumps(g["launches"]) + "; routes "
            + json.dumps(g["routes"]))
        log(f"{tag}: ragged_dot launches by route as the rule implies: "
            f"{implied['mma']} decode-shape (mma), {implied['wgmma']} "
            f"prefill-shape (wgmma)")
        if tag == "moe cold":
            main = g["launches"], g["routes"]
            require(calls["moe_apply_sorted_rows"] > 0
                    and tokens["moe_apply_sorted_rows"] > 2048
                    and calls["moe_apply_ragged"] > 0,
                    f"{tag}: both MoE dispatches must run: {calls} {tokens}")
        if tag == "moe radix":
            require(g["counters"].get("prefix_hits", 0) > 0,
                    "moe radix: no prefix hit")
        if tag == "moe int8":
            require(g["counters"].get("quant_dispatches", 0) > 0,
                    "moe int8: no int8 steps")
        del runs, g, e
    tag, scfg, prefix, reqs = moe_runs(cfg)[0]
    for mode in ("graph", "eager"):
        traced_run(f"{tag} {mode}", model, params, scfg, reqs, prefix,
                   graphs=mode == "graph")
    return main


def fresh_state(model, b: int, s: int, steps: int):
    """A fresh page-16 KV state with distinct frames for ``b`` rows of
    ``s`` prompt tokens and ``steps`` decode tokens (one scratch frame)."""
    import torch
    page = 16
    per = -(-(s + steps) // page)
    return model.init_kv_state(b, b * per + 1, page, per)._replace(
        page_table=torch.arange(b * per, dtype=torch.int32,
                                device=model.device).view(b, per))


def teacher_forced(model, params, tokens, lens, steps, forced=None):
    """One prefill of ``tokens [B, S]`` and ``steps`` decode steps on a
    fresh state, each decode step fed ``forced[t]`` (or its own argmax);
    returns the logits of each call ``[steps + 1, B, V]`` (f32), the tokens
    fed, and the expert ids of every ``router_topk`` call in order (none
    for a model without MoE layers)."""
    import torch
    from repro_torch.models import moe
    st = fresh_state(model, *tokens.shape, steps)
    ids, real = [], moe.router_topk

    def tap(p, x, k):
        out = real(p, x, k)
        ids.append(out[0].sort(-1).values)
        return out
    moe.router_topk = tap
    try:
        logits, st = model.prefill(params, tokens, lens, st)
        out, fed = [logits.float()], []
        for t in range(steps):
            tok = (forced[t] if forced is not None
                   else out[-1].argmax(-1).to(torch.int32))
            fed.append(tok)
            logits, st = model.decode_step(params, tok, st)
            out.append(logits.float())
    finally:
        moe.router_topk = real
    return torch.stack(out), fed, ids


def logits_gap(a, b, a_ids, b_ids, n_moe: int) -> dict:
    """How far two teacher-forced runs (:func:`teacher_forced`) are
    apart: each call's worst row error relative to that row's largest
    logit in ``b``, the share of (token, layer) expert sets alike, the
    layer calls fully alike, and the share alike by MoE layer (the mean
    over its calls; all empty for a model without MoE layers)."""
    rel = ((a - b).abs().amax(-1) / b.abs().amax(-1)).amax(-1)
    alike = [float((x == y).all(-1).float().mean())
             for x, y in zip(a_ids, b_ids)]
    total = sum(x.shape[0] for x in a_ids)
    same = sum(f * x.shape[0] for f, x in zip(alike, a_ids))
    return dict(rel=[float(r) for r in rel], same=same, total=total,
                calls=sum(f == 1 for f in alike), n_calls=len(alike),
                by_layer=[statistics.mean(alike[j::n_moe])
                          for j in range(n_moe)])


def log_gap(tag: str, what: str, gap: dict) -> None:
    experts = ""
    if gap["total"]:
        experts = (
            f"; expert sets equal for {gap['same']:.0f} of {gap['total']} "
            f"(token, layer) pairs ({100 * gap['same'] / gap['total']:.3f}%)"
            f", {gap['calls']} of {gap['n_calls']} layer calls fully alike; "
            "by MoE layer: "
            + ", ".join(f"{100 * x:.1f}%" for x in gap["by_layer"]))
    log(f"{tag} logits ({what}, teacher forced): worst row error / row "
        f"peak: prefill {gap['rel'][0]:.4g}, decode steps "
        + ", ".join(f"{r:.4g}" for r in gap["rel"][1:])
        + experts + " (printed, not required)")


def plain_of(model):
    """The model's plain-path twin (``use_kernels=False``, what
    ``ServeConfig.use_ref_path`` serves): a shallow copy."""
    import copy
    twin = copy.copy(model)
    twin.use_kernels = False
    return twin


def logits_phase(tag, cfg, model, params, b: int, s: int,
                 steps: int = LOGIT_STEPS) -> dict[str, dict]:
    """The kernel path against the plain path on the card in bf16, teacher
    forced on the same tokens: one prefill of ``b`` x ``s`` tokens, then
    ``steps`` decode steps fed the kernel path's greedy tokens.  The
    witness that tells rounding from a fault: both paths again in f32 on
    the same weights (upcast; the CUDA-core routes, exact f32 sums), fed
    the same tokens.  Prints, for kernel vs plain in bf16 and in f32, and
    for the bf16 kernel path and the bf16 plain path each against the f32
    plain path, each call's worst row error relative to that row's largest
    logit (and, for MoE, the share of (token, layer) expert sets alike); a
    measurement, not a gate.  Returns the four gaps by name."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)).cuda()
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    n_moe = sum(model.is_moe(i) for i in range(cfg.num_layers))
    k_logits, fed, k_ids = teacher_forced(model, params, tokens, lens, steps)
    ops.reset_launch_counts()
    p_logits, _, p_ids = teacher_forced(plain_of(model), params, tokens,
                                        lens, steps, forced=fed)
    require(sum(ops.launch_counts().values()) == 0,
            f"{tag} logits: the plain path launched a kernel")
    model32 = build_model(dataclasses.replace(cfg, param_dtype="float32"),
                          device="cuda")
    params32 = to_device(params, torch.float32)
    log(f"{tag} logits: f32 weights on the card, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    k32, _, k32_ids = teacher_forced(model32, params32, tokens, lens,
                                     steps, forced=fed)
    p32, _, p32_ids = teacher_forced(plain_of(model32), params32, tokens,
                                     lens, steps, forced=fed)
    del params32
    require(all(bool(torch.isfinite(x).all())
                for x in (k_logits, p_logits, k32, p32)),
            f"{tag} logits: non-finite logits")
    gaps = {}
    for what, a, a_ids, ref_, ref_ids in (
            ("kernel vs plain path, bf16", k_logits, k_ids, p_logits, p_ids),
            ("kernel vs plain path, f32", k32, k32_ids, p32, p32_ids),
            ("bf16 kernel path vs f32 plain path", k_logits, k_ids, p32,
             p32_ids),
            ("bf16 plain path vs f32 plain path", p_logits, p_ids, p32,
             p32_ids)):
        gaps[what] = logits_gap(a, ref_, a_ids, ref_ids, n_moe)
        log_gap(tag, what, gaps[what])
    return gaps


def moe_logits_phase(cfg, model, params) -> float:
    """:func:`logits_phase` on granite-moe (4 x 256 tokens, 8 decode
    steps), then the ``ragged_dot`` launches of one decode step (eager);
    returns them."""
    import torch
    from repro_torch.kernels import ops
    logits_phase("moe", cfg, model, params, 4, 256)
    tokens = torch.zeros((4, 16), dtype=torch.int32, device="cuda")
    lens = torch.full((4,), 16, dtype=torch.int32, device="cuda")
    n_moe = sum(model.is_moe(i) for i in range(cfg.num_layers))
    # launches of one decode step on the kernel path, eager
    ops.reset_launch_counts()
    teacher_forced(model, params, tokens, lens, 1)
    per_prefill = ops.launch_counts()["ragged_dot"]
    ops.reset_launch_counts()
    teacher_forced(model, params, tokens, lens, 2)
    per_step = ops.launch_counts()["ragged_dot"] - per_prefill
    require(per_step == 3 * n_moe,
            f"moe: {per_step} ragged_dot launches a decode step, want "
            f"3 a MoE layer ({3 * n_moe})")
    log(f"moe: {per_step} ragged_dot launches per decode token-step (3 per "
        f"MoE layer x {n_moe})")
    return per_step


def moe_decode_profile(cfg, model, params, steps: int = 8) -> None:
    """An untimed, traced repeat (torch.profiler) of ``steps`` eager decode
    steps of 4 lanes after a 4 x 256-token prefill: device time by kernel
    per decode token-step, and ``ragged_dot``'s share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import print_profile
    rng = np.random.default_rng(10)
    b, s = 4, 256
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)).cuda()
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    logits, st = model.prefill(params, tokens, lens,
                               fresh_state(model, b, s, steps))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, st = model.decode_step(
                params, logits.argmax(-1).to(torch.int32), st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"moe profile: {steps} eager decode steps of {b} lanes (device time "
        "by kernel; divide by the steps for one token-step):")
    print_profile(prof, wall, top=15)
    ms, count, share = kernel_share(prof, *RAGGED_KERNELS)
    log(f"moe profile: ragged_dot {ms / steps:.3f} ms and {count / steps:.0f} "
        f"launches per decode token-step, {share:.1f}% of device time")


def moe_operands(gen, m, k, n, e, top, sizes=None):
    """bf16 operands of one grouped product at granite-moe's widths: rows
    routed top-``top`` over ``e`` experts (``m / top`` tokens), or
    ``sizes``."""
    import torch
    xs = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((e, k, n), generator=gen, device="cuda")
         / k ** 0.5).bfloat16()
    if sizes is None:
        logits = torch.randn((m // top, e), generator=gen, device="cuda")
        ids = logits.topk(top, dim=-1).indices.flatten()
        sizes = torch.bincount(ids, minlength=e).int()
    else:
        sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    return xs, w, sizes


def grouped_mm(xs, w, sizes):
    """``torch._grouped_mm`` on the same operands (the yardstick: the port
    never calls it), with the layout it takes, or ``None`` and why."""
    import torch
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch has no _grouped_mm"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    errors = []
    for layout, wl in (("row-major w", w),
                       ("column-major w", w.transpose(1, 2).contiguous()
                        .transpose(1, 2))):
        try:
            fn(xs, wl, offs=offs)
            torch.cuda.synchronize()
            return (lambda: fn(xs, wl, offs=offs)), layout
        except (RuntimeError, TypeError, ValueError) as err:
            errors.append(f"{layout}: {str(err).splitlines()[0][:120]}")
    return None, "; ".join(errors)


def moe_kernel_rows(cfg, routes, per_step) -> list[dict]:
    """``ragged_dot`` against its plain version at granite-moe's full-width
    shapes: decode rows (4 lanes x 8 = 32) and a 2,048-token prefill
    (16,384 rows) for the up/gate product (1024 -> 512) and the down
    product (512 -> 1024), every expert but one touched at decode, one
    expert holding every row; each on the route ``ragged_route`` picks
    (decode ``"mma"``, prefill ``"wgmma"``), held by ``bf16_rows_check``
    with the rows past the last group zero, and launched twice for
    bit-identical outputs.  Then the device times of kernel, plain version
    and ``torch._grouped_mm`` beside the bound: the bytes of xs, of the
    touched experts' weights and of the output over HBM bandwidth, or 2 M
    K N over the bf16 tensor-core peak, whichever is longer.  Returns the
    decode and prefill up/gate rows, with the cold run's launches on
    their routes (``routes``)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ragged_dot import ragged_dot, ragged_route
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    m_dec = MOE_SERVE["max_batch"] * cfg.experts_per_token
    m_pre = 2048 * cfg.experts_per_token
    gen = torch.Generator(device="cuda").manual_seed(11)
    shapes = (
        ("ragged_dot", "decode up/gate", m_dec, d, f, None),
        ("ragged_dot_decode_down", "decode down", m_dec, f, d, None),
        ("ragged_dot_prefill", "prefill up/gate", m_pre, d, f, None),
        ("ragged_dot_prefill_down", "prefill down", m_pre, f, d, None),
        ("ragged_dot_empty", "one expert empty", m_dec, d, f,
         [0] + [m_dec // (e - 1)] * (e - 2) + [m_dec - m_dec // (e - 1)
                                              * (e - 2)]),
        ("ragged_dot_all_rows", "one expert holds every row", m_pre, d, f,
         [0] * (e - 1) + [m_pre]),
    )
    rows = []
    for name, what, m, k, n, sizes in shapes:
        xs, w, gs = moe_operands(gen, m, k, n, e, cfg.experts_per_token,
                                 sizes)
        route = ragged_route(xs, w)
        require(route == ("mma" if m == m_dec else "wgmma"),
                f"{name}: route {route} at M = {m}")
        ops.reset_launch_counts()
        got = ops.ragged_dot(xs, w, gs)
        again = ops.ragged_dot(xs, w, gs)
        require(ops.route_counts()["ragged_dot"] == {
            **dict.fromkeys(routes["ragged_dot"], 0), route: 2},
            f"{name}: off its {route} route")
        want = ref.ragged_dot_ref(xs, w, gs)
        err, peak = bf16_rows_check(name, got, want)
        require(torch.equal(got, again),
                f"{name}: two launches on the same operands differ")
        require(not got[int(gs.sum()):].any(),
                f"{name}: rows past the last group are not zero")
        touched = int((gs > 0).sum())
        nbytes = (m * k + touched * k * n + m * n) * 2 + e * 4
        b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
        ms = time_ms(lambda: ragged_dot(xs, w, gs))
        plain_ms = time_ms(lambda: ref.ragged_dot_ref(xs, w, gs), n=5,
                           reps=3)
        lib, layout = grouped_mm(xs, w, gs)
        lib_ms = None
        if lib is not None:
            lib_err = max_err(lib(), want)
            lib_ms = time_ms(lib)
            layout += f", |err| vs plain {lib_err:.3g}"
        log(f"ragged_dot {what}: route {route}, kernel {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of it), plain "
            f"{plain_ms:.4f} ms, torch._grouped_mm "
            + ("-" if lib_ms is None else f"{lib_ms:.4f} ms") + " [" + CARD
            + "]")
        rows.append(dict(
            name=name, shape=f"{what}: xs [{m}, {k}] @ w [{e}, {k}, {n}] "
            f"bf16, {touched} experts touched, route {route}",
            max_abs_err=err, max_abs_want=peak, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library=f"torch._grouped_mm ({layout})",
            launches=routes["ragged_dot"][route]
            if name in ("ragged_dot", "ragged_dot_prefill") else None))
        del xs, w, gs, got, again, want
    print_rows(rows)
    dec = rows[0]
    log(f"kernel ragged_dot: {per_step} launches per decode token-step "
        f"(3 per MoE layer); decode up/gate {dec['ms']:.4f} ms = "
        f"{dec['ms'] / dec['bound_ms']:.2f}x its bound; the whole decode "
        f"step's grouped products {per_step // 3} x (2 up/gate + 1 down) "
        f"~{per_step // 3 * (2 * dec['ms'] + rows[1]['ms']):.3f} ms")
    return rows[:1] + rows[2:3]


def moe_attention_checks(cfg, model, params) -> None:
    """The copy and attention kernels at the MoE path's own shapes (Hkv 8,
    G 2, head_dim 64): granite-moe's cold, int8 and radix runs repeated,
    untimed, inside ``disable_graphs()`` with :func:`record_inputs`, plus
    the radix workload on int8 pools (the int8 continuation attention),
    then :func:`attention_checks` on the largest call of each."""
    from repro_torch.serve import disable_graphs
    cold, int8, radix = (run[1:] for run in moe_runs(cfg))
    radix_int8 = (dataclasses.replace(radix[0], kv_dtype="int8"), None,
                  radix_workload(cfg.vocab_size, n=4, max_new=16))
    with disable_graphs():      # the recorders read each call's inputs
        rec, rec_q, rec_pq = record_inputs(model, params, cold, int8,
                                           [radix], radix_int8)
    require(all(r.best is not None for r in (*rec.values(), rec_q, rec_pq)),
            "moe: a copy or attention kernel was never called while "
            "recording")
    attention_checks("moe", rec, rec_q, rec_pq)


def moe_phases() -> list[dict]:
    """The granite-moe-1b-a400m phases: serve (graphs and eager), the copy
    and attention kernels checked at the path's shapes, the logits
    comparison, a traced decode, and the ``ragged_dot`` rows; the weights
    are freed on return."""
    cfg, model, params = moe_full_model()
    _, routes = moe_serve_phase(cfg, model, params)
    moe_attention_checks(cfg, model, params)
    per_step = moe_logits_phase(cfg, model, params)
    moe_decode_profile(cfg, model, params)
    return moe_kernel_rows(cfg, routes, per_step)


# ---------------------------------------------------------------------------
# the VLM (qwen2-vl-7b) and audio (musicgen-large) families
# ---------------------------------------------------------------------------


#: the configs of the VLM and audio families
FAMILY_ARCHS = ("qwen2-vl-7b", "musicgen-large")


def reduced_family_check() -> None:
    """The reduced qwen2-vl (M-RoPE, biases) and musicgen (4 codebooks:
    ``[len, 4]`` prompts, ``[4]`` tokens a step) engines, f32 and 2
    layers, on the card (graphs) against the same engines and weights on
    the CPU: cold (preemption), int8 pools and the default policy (radix
    hits), with identical greedy tokens, every counter (less
    ``prefill_bytes_gathered``, which counts by route) and switch stats,
    and the path's kernels launched."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch, reduced=True)
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(0)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = to_device(cpu_params, "cuda")
        tok = cpu_model.token_shape
        cold = dict(page_size=4, num_pages=16, max_pages_per_seq=16,
                    max_batch=3, prefix_cache=False, restore_patience=0)
        cases = (
            ("cold", ServeConfig(**cold), serve_workload(
                cfg.vocab_size, n=7, lo=4, hi=13, max_new=12, seed=13,
                tok=tok)),
            ("int8", ServeConfig(**cold, kv_dtype="int8"), serve_workload(
                cfg.vocab_size, n=7, lo=4, hi=13, max_new=12, seed=13,
                tok=tok)),
            ("default policy", ServeConfig(
                page_size=4, num_pages=16, max_pages_per_seq=16,
                max_batch=3), reduced_radix_workload(cfg.vocab_size, tok)),
        )
        for tag, scfg, reqs in cases:
            ops.reset_launch_counts()
            e_gpu, r_gpu, _ = run_engine(gpu_model, gpu_params, scfg, reqs)
            launches = ops.launch_counts()
            e_cpu, r_cpu, _ = run_engine(cpu_model, cpu_params, scfg, reqs)
            c_cpu = dict(e_cpu.counters.counters)
            c_gpu = dict(e_gpu.counters.counters)
            for c in (c_cpu, c_gpu):
                c.pop("prefill_bytes_gathered", None)
            diff = {k: (c_cpu.get(k), c_gpu.get(k))
                    for k in set(c_cpu) | set(c_gpu)
                    if c_cpu.get(k) != c_gpu.get(k)}
            require(not diff, f"reduced {arch} ({tag}) counters differ card "
                              f"vs cpu: {diff}")
            require(token_lists(r_cpu) == token_lists(r_gpu),
                    f"reduced {arch} ({tag}) tokens differ card vs cpu")
            require(e_gpu.stats()["switch_stats"]
                    == e_cpu.stats()["switch_stats"],
                    f"reduced {arch} ({tag}) switch stats differ")
            require(all(np_shape(r.tokens) == (12,) + tok
                        for r in r_gpu.values()),
                    f"reduced {arch} ({tag}): a request's tokens are not "
                    f"[12{', ' + str(tok[0]) if tok else ''}]")
            for n in CONT_KERNELS if tag == "default policy" \
                    else COLD_KERNELS:
                require(launches[n] > 0,
                        f"reduced {arch} ({tag}): {n} never launched")
            if tag == "default policy":
                require(c_gpu.get("prefix_hits", 0) > 0,
                        f"reduced {arch}: no prefix hit")
            else:
                require(c_gpu.get("preemptions", 0) > 0,
                        f"reduced {arch} ({tag}): no preemption")
            log(f"check reduced {arch} engine ({tag}): card == cpu greedy "
                f"tokens, all counters and switch stats; preemptions "
                f"{c_gpu.get('preemptions', 0)}, prefix_hits "
                f"{c_gpu.get('prefix_hits', 0)}; launches "
                + json.dumps({k: v for k, v in launches.items() if v}))


def np_shape(tokens) -> tuple:
    import numpy as np
    return np.shape(np.asarray(tokens))


def family_full_model(arch: str):
    """``arch`` at full width on the card, all its layers, random bf16
    weights from seed 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)                 # depth not cut
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = tree_numel(params)
    log(f"{arch}: full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv of "
        f"{cfg.head_dim} (G {cfg.q_per_kv}), d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}"
        + (f" x {cfg.num_codebooks} codebooks" if model.token_shape else "")
        + (f", M-RoPE sections {cfg.mrope_sections}"
           if cfg.mrope_sections else "")
        + f", bf16, {n_params / 1e9:.2f} B parameters) initialised on the "
        f"card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    return cfg, model, params


def tree_numel(p) -> int:
    if isinstance(p, dict):
        return sum(tree_numel(v) for v in p.values())
    if isinstance(p, list):
        return sum(tree_numel(v) for v in p)
    return p.numel()


def family_runs(cfg, model):
    """``(tag, ServeConfig, prefix, requests)`` of a family's serve phase:
    the dense path's cold workload (8 requests of 64-512 tokens, 32 new,
    72 frames, radix off), for audio an int8 run of the short workload, and
    the default policy on the radix workload (64 frames: preemptions and
    restores).  Audio prompts are ``[len, K]`` codebook frames."""
    from repro_torch.serve import ServeConfig
    tag, tok = ("audio", model.token_shape) if model.token_shape else \
        ("vlm", ())
    scfg = ServeConfig(**SERVE)
    runs = [(f"{tag} cold", scfg, None,
             serve_workload(cfg.vocab_size, **WORKLOAD, tok=tok))]
    if tok:
        runs.append((f"{tag} int8", dataclasses.replace(scfg, kv_dtype="int8"),
                     None, serve_workload(cfg.vocab_size, **SHORT, tok=tok)))
    runs.append((f"{tag} radix", ServeConfig(**CONT), None,
                 radix_workload(cfg.vocab_size, tok=tok)))
    return runs


def family_serve_phase(cfg, model, params, runs) -> dict[str, dict]:
    """Each run with CUDA graphs and inside ``disable_graphs()``: identical
    greedy tokens, counters, switch stats, launches and routes; decode
    replays in the graph run only; every attention and copy launch on its
    tensor-core or ``burst`` route (``flash_attention`` on ``wgmma``); one
    copy launch a layer of every prefill; the path's kernels launched;
    every request done with ``max_new`` tokens of the model's token shape
    inside the vocabulary.  Then the cold run traced, graphs and eager.
    Returns, by tag, the graph run's launches and counters, tok/s, TTFT
    and TPOT p50, and the traced cold runs' splits."""
    out = {}
    for tag, scfg, prefix, reqs in runs:
        runs_ = {}
        for mode in ("graph", "eager"):
            with PrefillTap(model) as tap:
                runs_[mode] = served(model, params, scfg, reqs, prefix,
                                     graphs=mode == "graph")
                tap.require_copy_launches(f"{tag} {mode}",
                                          runs_[mode]["launches"],
                                          cfg.num_layers)
        for mode, r in runs_.items():
            report(f"{tag} {mode}", r["eng"], r["res"], r["dt"], CONT_KEYS)
            log(f"{tag} {mode}: engine built in {r['build']:.2f}s")
        g, e = runs_["graph"], runs_["eager"]
        require_same(tag, g, e)
        require(replays_of(g["replays"], "decode", "decode_multi") > 0
                and e["replays"] == {},
                f"{tag}: no decode replay in the graph run, or a replay in "
                "the eager run")
        require_tensor_core_routes(tag, g["launches"])
        require(g["routes"]["flash_attention"] == {
            "wgmma": g["launches"]["flash_attention"], "simt": 0},
            f"{tag}: flash_attention off the tensor-core route: "
            f"{g['routes']['flash_attention']}")
        for n in COLD_KERNELS if not tag.endswith("radix") else CONT_KERNELS:
            require(g["launches"][n] > 0, f"{tag}: {n} never launched")
        want = (reqs[0].max_new_tokens,) + model.token_shape
        require(all(r.status == "done" and np_shape(r.tokens) == want
                    for r in g["res"].values())
                and all(0 <= t < cfg.vocab_size for toks in
                        g["tokens"].values() for t in flat(toks)),
                f"{tag}: a request did not finish with {list(want)} tokens "
                "inside the vocabulary")
        c = g["counters"]
        if tag.endswith("cold"):
            require(c.get("preemptions", 0) > 0
                    and g["switch"]["bytes_spilled"]
                    == g["switch"]["bytes_restored"] > 0,
                    f"{tag}: no preemption, or bytes spilled != restored")
        if tag.endswith("int8"):
            require(c.get("quant_dispatches", 0) > 0, f"{tag}: no int8 steps")
        if tag.endswith("radix"):
            require(c.get("prefix_hits", 0) > 0, f"{tag}: no prefix hit")
            if model.token_shape:
                require(c.get("preemptions", 0) > 0
                        and c.get("restores", 0) > 0,
                        f"{tag}: the pool never preempted and restored")
        res = g["res"]
        done = [r for r in res.values() if r.status == "done"]
        out[tag] = dict(
            launches=g["launches"], counters=c,
            tok_s=sum(len(r.tokens) for r in res.values()) / g["dt"],
            ttft=sorted(r.ttft for r in done)[len(done) // 2],
            tpot=sorted(r.tpot for r in done)[len(done) // 2])
        log(f"{tag}: graph == eager in greedy tokens, counters, switch "
            f"stats, launches and routes; replays "
            + json.dumps({f"{k}:{n}": v for (k, n), v in g["replays"].items()})
            + "; launches " + json.dumps(g["launches"]) + "; routes "
            + json.dumps(g["routes"]))
        del runs_, g, e
    tag, scfg, prefix, reqs = runs[0]
    for mode in ("graph", "eager"):
        out[tag][f"traced {mode}"] = traced_run(
            f"{tag} {mode}", model, params, scfg, reqs, prefix,
            graphs=mode == "graph")
    return out


def flat(toks) -> list:
    """A request's tokens as one flat list of ints."""
    import numpy as np
    return np.asarray(toks).reshape(-1).tolist()


def report_family(arch, model, out) -> None:
    """The end-to-end line of each run (frames of K codebook tokens for
    audio), with the card's name and power limit."""
    unit = (f"frames of {model.token_shape[0]} tokens" if model.token_shape
            else "tokens")
    for tag, r in out.items():
        traced = ""
        if "traced graph" in r:
            tg, te = r["traced graph"], r["traced eager"]
            traced = (f"; traced cold: {tg['share']:.1f}% busy with graphs "
                      f"({te['share']:.1f}% eager), "
                      f"{tg['kernels_per_step']:.1f} kernels and "
                      f"{tg['device_ms_per_step']:.2f} ms of kernel time per "
                      "decode token-step")
        log(f"{arch} {tag} [{CARD}]: {r['tok_s']:.1f} {unit}/s, TTFT p50 "
            f"{r['ttft'] * 1e3:.1f} ms, TPOT p50 {r['tpot'] * 1e3:.2f} ms"
            + traced)


#: the stub vision prefix of the dense VLM serve check: ``N_VIS`` patch
#: embeddings (``src/repro/launch/specs.py``), in a 512-token prompt
N_VIS, VIS_PROMPT = 256, 512


def vision_prefill_check(cfg, model, params) -> None:
    """A direct ``prefill`` of 2 rows of 512 tokens whose first 256
    positions are a stub vision prefix (precomputed patch embeddings,
    seeded normal x 0.02, as the data pipeline draws them), through the
    kernel path (one copy and one flash launch a layer, on their fast
    routes) and the plain path: the worst row's logit gap as a share of
    that row's peak, against the shift the prefix itself causes (the same
    tokens without it).  A gap past 32 bf16 steps of the row's peak, or
    not well below the prefix's own shift, fails."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(12)
    b, s = 2, VIS_PROMPT
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)).cuda()
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    vis = torch.from_numpy((rng.normal(size=(b, N_VIS, cfg.d_model))
                            * 0.02).astype(np.float32)).cuda()
    ops.reset_launch_counts()
    k_logits, _ = model.prefill(params, tokens, lens,
                                fresh_state(model, b, s, 0),
                                vision_embeds=vis)
    launches, routes = ops.launch_counts(), ops.route_counts()
    require(launches["paged_copy"] == launches["flash_attention"]
            == cfg.num_layers
            and routes["flash_attention"]["wgmma"] == cfg.num_layers
            and routes["paged_copy"]["burst"] == cfg.num_layers,
            f"vlm vision prefill: launches {launches}, routes {routes}")
    p_logits, _ = plain_of(model).prefill(params, tokens, lens,
                                          fresh_state(model, b, s, 0),
                                          vision_embeds=vis)
    t_logits, _ = model.prefill(params, tokens, lens,
                                fresh_state(model, b, s, 0))
    k, p, t = (x.float() for x in (k_logits, p_logits, t_logits))
    require(all(bool(torch.isfinite(x).all()) for x in (k, p, t))
            and k.shape == (b, cfg.vocab_size),
            "vlm vision prefill: non-finite logits or a wrong shape")
    peak = p.abs().amax(-1)
    gap = float(((k - p).abs().amax(-1) / peak).max())
    shift = float(((t - k).abs().amax(-1) / peak).min())
    require(gap <= 32 * 2**-8 and gap < shift / 2,
            f"vlm vision prefill: kernel vs plain gap {gap:.4g} of the row "
            f"peak (limit {32 * 2**-8:.4g}, and below half the prefix's "
            f"own shift {shift:.4g})")
    log(f"vlm vision prefill ({b} x {s} tokens, the first {N_VIS} a stub "
        f"vision prefix): kernel vs plain path worst row gap {gap:.4g} of "
        f"the row peak; the prefix moves the logits by >= {shift:.4g} of "
        f"the row peak; {cfg.num_layers} paged_copy (burst) and "
        f"{cfg.num_layers} flash_attention (wgmma) launches [{CARD}]")


def vlm_phases() -> None:
    """qwen2-vl-7b at full width (28 layers, M-RoPE): the cold and radix
    serve runs (graphs == eager, traced cold), the vision-prefix prefill,
    and the kernel-vs-plain logits in bf16 and f32 (qwen2-7b's geometry:
    Hkv 4, G 7, head_dim 128).  No kernel rows: its kernels run at the
    dense path's shapes, which :func:`dense_phases` times."""
    cfg, model, params = family_full_model("qwen2-vl-7b")
    out = family_serve_phase(cfg, model, params, family_runs(cfg, model))
    report_family("qwen2-vl-7b", model, out)
    vision_prefill_check(cfg, model, params)
    logits_phase("vlm", cfg, model, params, 2, 256)


def audio_attention_checks(cfg, model, params, runs):
    """The copy and attention kernels at musicgen's own recorded shapes
    (Hkv 32, G 1, head_dim 64, page 16): the cold, int8 and radix runs and
    the radix workload on int8 pools repeated, untimed, inside
    ``disable_graphs()`` with :func:`record_inputs`, then
    :func:`attention_checks` on the largest call of each.  Returns the
    recorders."""
    from repro_torch.serve import disable_graphs
    cold, int8, radix = (run[1:] for run in runs)
    # all 8 radix prompts (16 new): the first 4 hold no radix hit when
    # their tails are frames of 4 codebooks
    radix_int8 = (dataclasses.replace(radix[0], kv_dtype="int8"), None,
                  radix_workload(cfg.vocab_size, max_new=16,
                                 tok=model.token_shape))
    with disable_graphs():      # the recorders read each call's inputs
        rec, rec_q, rec_pq = record_inputs(model, params, cold, int8,
                                           [radix], radix_int8)
    require(all(r.best is not None for r in (*rec.values(), rec_q, rec_pq)),
            "audio: a copy or attention kernel was never called while "
            "recording")
    attention_checks("audio", rec, rec_q, rec_pq)
    return rec, rec_q, rec_pq


def audio_phases() -> list[dict]:
    """musicgen-large at full width (48 layers, 4 codebooks): the cold,
    int8 and radix serve runs (graphs == eager, traced cold), the copy and
    attention kernels held against their plain versions at its G 1
    shapes, and the G 1 rows of both paged attention kernels (timed, with
    the audio runs' launches); the weights are freed on return."""
    cfg, model, params = family_full_model("musicgen-large")
    runs = family_runs(cfg, model)
    out = family_serve_phase(cfg, model, params, runs)
    report_family("musicgen-large", model, out)
    rec, rec_q, rec_pq = audio_attention_checks(cfg, model, params, runs)
    cold, int8, radix = (out[tag]["launches"] for tag in
                         ("audio cold", "audio int8", "audio radix"))
    rows = [decode_row("paged_decode_attention_g1",
                       rec["paged_decode_attention"].best,
                       cold["paged_decode_attention"]),
            decode_row("paged_decode_attention_int8_g1", rec_q.best,
                       int8["paged_decode_attention"]),
            prefill_row("paged_prefill_attention_g1",
                        rec["paged_prefill_attention"],
                        radix["paged_prefill_attention"])]
    print_rows(rows)
    log(f"audio: kernel launches on the serve runs [{CARD}]: cold "
        + json.dumps(cold) + ", int8 " + json.dumps(int8) + ", radix "
        + json.dumps(radix))
    return rows


def print_rows(rows) -> None:
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"kernel {r['name']}: {r['shape']}; err {r['max_abs_err']:.3g} "
            f"(max|want| {r['max_abs_want']:.3g}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{lib} ({r['library']}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), " + ("not a shape of any path"
                                      if r["launches"] is None else
                                      f"{r['launches']} launches on its path"))


def dense_phases() -> list[dict]:
    """The qwen2-7b phases (cold, int8, horizon, continuation, graphs,
    buckets, router) and their kernel rows; the model and every recorded input are
    freed on return."""
    from repro_torch.serve import ServeConfig, disable_graphs
    cfg, model, params = full_model()
    launches, launches_q = serve_phase(cfg, model, params)
    counts = continuation_phase(cfg, model, params)
    graph_phase(cfg, model, params)
    bucket_phase(cfg, model, params)
    router_phase(cfg, model, params)
    runs = [run[1:] for run in continuation_runs(cfg)]
    scfg = ServeConfig(**SERVE)
    with disable_graphs():      # the recorders read each call's inputs
        rec, rec_q, rec_pq = record_inputs(
            model, params,
            (scfg, None, serve_workload(cfg.vocab_size, **WORKLOAD)),
            (dataclasses.replace(scfg, kv_dtype="int8"), None,
             serve_workload(cfg.vocab_size, **SHORT)), runs[:2], runs[2])
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
    t0 = time.perf_counter()
    try:
        probe()
        build()
        reduced_checks()
        reduced_wkv_checks()
        reduced_engine_check()
        reduced_moe_check()
        reduced_family_check()
        reduced_router_check()
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
        gc.collect()                   # free the rwkv6-7b weights first
        torch.cuda.empty_cache()
        rows += moe_phases()
        gc.collect()                   # free the granite-moe weights first
        torch.cuda.empty_cache()
        vlm_phases()
        gc.collect()                   # free the qwen2-vl-7b weights first
        torch.cuda.empty_cache()
        rows += audio_phases()
        gc.collect()
        torch.cuda.empty_cache()
        rows += vm_phases()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f}s "
        f"[{CARD}]")
    kernels = []
    for r in rows:
        source, replaces = KERNELS[r["name"].removesuffix("_g1")
                                   .removesuffix("_prefill")
                                   .removesuffix("_int8")
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
