#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves on the card.

    python3 chip_smoke.py            # one CUDA card, ~1-2 minutes

Imports nothing of JAX and nothing of the JAX package (``src/repro``); it
puts ``src`` on ``sys.path`` and drives ``repro_torch``.  Phases, each
printing its lines; any failure exits non-zero before the last line:

1. probe: the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions, the TF32 switches (both set off: the f32 checks are f32);
2. build: every CUDA kernel of the serve path from ``src/repro_torch/
   kernels/csrc`` (one nvcc per source, in parallel), with its time;
3. reduced check: each kernel against its plain PyTorch version on the
   card at the reduced qwen2-7b shapes in f32 (D=14, G=2), with ragged
   lengths, -1 table entries, an empty sequence, a window and int8 pools,
   and the reduced engine on the card against the same engine on the CPU;
4. serve: qwen2-7b at full width (bf16, random weights from a seeded
   generator) serves 8 requests (64-512-token prompts, 32 new tokens,
   page 16, horizon 8) in a pool tight enough to preempt; launch counts
   are zeroed just before and read just after, and every kernel must have
   launched; then a short int8-pool run, and a short workload that must
   give the same greedy tokens at horizon 8 and 1;
5. full-width check and timing: each kernel against its plain version on
   the largest inputs an untimed repeat of the serve runs gave it (bf16,
   within four bf16 steps of the largest output), then the device time of
   kernel, plain version and one PyTorch library call that computes the
   same function (a yardstick the port never calls), from CUDA events
   around 50 back-to-back calls with a cold L2, beside the least time the
   card could take (bytes / 3.35 TB/s or operations / 989 TFLOP/s bf16);
6. the kernel JSON line, then the device JSON line, last.
"""

from __future__ import annotations

import dataclasses
import functools
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
    the serve path gave it."""

    def __init__(self, fn, work):
        self.fn, self.work, self.best, self.best_work = fn, work, None, -1

    def __call__(self, *args, **kw):
        w = self.work(*args, **kw)
        if w > self.best_work:
            self.best_work = w
            self.best = ([a.clone() if hasattr(a, "clone") else a
                          for a in args], dict(kw))
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


def reduced_checks() -> None:
    """Each kernel vs its plain version at the reduced f32 shapes.  f32
    tolerance 1e-5: both sides accumulate in f32, only the summation order
    differs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.paged_copy import paged_copy
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
    ops.reset_launch_counts()


def run_engine(model, params, serve_cfg, reqs):
    from repro_torch.serve import Engine
    eng = Engine(model, params, serve_cfg)
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
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig
    cfg = get_config("qwen2-7b", reduced=True)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(0)
    gpu_model = build_model(cfg, device="cuda")

    def to_gpu(p):
        if isinstance(p, dict):
            return {k: to_gpu(v) for k, v in p.items()}
        if isinstance(p, list):
            return [to_gpu(v) for v in p]
        return p.to("cuda")

    gpu_params = to_gpu(cpu_params)
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


def report(tag, eng, res, dt):
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
            "ref_path_dispatches", "quant_dispatches")
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
    for n, k in launches.items():
        require(k > 0, f"{n} was never launched on the serve path")
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


def record_inputs(cfg, model, params):
    """Repeat the two serve runs, untimed, with each ``ops`` wrapper
    wrapped in a :class:`Recorder` (which synchronizes to weigh each call),
    and return the recorders of the full-width run and the int8 decode
    recorder."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig

    rec = {
        "paged_copy": Recorder(
            ops.paged_copy, lambda src, pool, pt, lens, **k: int(lens.sum())),
        "flash_attention": Recorder(
            ops.flash_attention, lambda q, k, v, **kw: q.numel()),
        "paged_decode_attention": Recorder(
            ops.paged_decode_attention,
            lambda q, kp, vp, pt, sl, **kw: int(sl[:q.shape[0]].sum())),
    }
    saved = {n: getattr(ops, n) for n in rec}
    for n, r in rec.items():
        setattr(ops, n, r)
    try:
        scfg = ServeConfig(**SERVE)
        run_engine(model, params, scfg,
                   serve_workload(cfg.vocab_size, **WORKLOAD))
        rec_q = Recorder(saved["paged_decode_attention"],
                         rec["paged_decode_attention"].work)
        ops.paged_decode_attention = rec_q
        run_engine(model, params, dataclasses.replace(scfg, kv_dtype="int8"),
                   serve_workload(cfg.vocab_size, **SHORT))
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)
    return rec, rec_q


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
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"kernel {r['name']}: {r['shape']}; err {r['max_abs_err']:.3g} "
            f"(max|want| {r['max_abs_want']:.3g}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{lib} ({r['library']}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['launches']} serve launches")
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
        reduced_engine_check()
        if quick:
            log("quick: stopping after the reduced checks")
            return 0
        cfg, model, params = full_model()
        launches, launches_q = serve_phase(cfg, model, params)
        rec, rec_q = record_inputs(cfg, model, params)
        rows = full_checks(rec, rec_q, launches, launches_q)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for r in rows:
        base = "paged_decode_attention" if r["name"].endswith("_int8") \
            else r["name"]
        source, replaces = KERNELS[base]
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
