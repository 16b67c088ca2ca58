"""Serving launcher on the card: ``python -m repro_torch.launch.serve [...]``.

Spins up the split serving engine (host Scheduler = policy plane, device
Executor = data plane with the CUDA kernels; see
``repro_torch/serve/engine.py``) with random weights from a seeded
``torch.Generator`` and reports the paper-aligned statistics: page faults,
context-switch bytes/cycles, page-table delta uploads, tokens/s on the
card.

This slice of the port serves with the radix prefix cache OFF and partial
restore OFF (``prefix_cache=False``, ``restore_patience=0``): both ride
the continuation kernels, which a later slice ports.  The serving flags
come from ``ServeConfig.add_args``; ``--no-prefix-cache`` is implied.

The model is the arch's reduced config unless ``--full`` asks for the
published widths; ``--num-layers`` cuts depth only.  ``--device cpu``
runs the plain PyTorch versions of the kernels on the CPU.  The kernels
are built and one short request is served before the timed run, so
tokens/s and TTFT exclude the build and first-call costs; ``--profile``
traces the timed run (torch.profiler) and prints device time by kernel
and the device's busy and idle shares.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.serve import Engine, ServeConfig, ServeRequest


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def print_profile(prof, wall_s: float, top: int = 15) -> None:
    """Device time by kernel (device-side events only, so a kernel is not
    counted again under the CPU op that launched it) and the share of the
    wall-clock window the device was busy."""
    from torch.autograd import DeviceType
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU),
                  key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in rows)
    share = busy_us / 1e4 / wall_s
    print(f"profile: device busy {busy_us / 1e3:.1f} ms of "
          f"{wall_s * 1e3:.1f} ms wall ({share:.1f}% busy, "
          f"{100 - share:.1f}% idle)")
    for e in rows[:top]:
        us = _device_us(e)
        print(f"  {us / 1e3:9.2f} ms {100 * us / max(busy_us, 1e-9):5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-7b")
    ap.add_argument("--full", action="store_true",
                    help="published widths (bf16) instead of the reduced "
                         "config")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut depth to this many layers (0 = the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve run with torch.profiler and print "
                         "device time by kernel and the device busy share")
    ServeConfig.add_args(ap)
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=not args.full)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    serve_cfg = ServeConfig.from_args(
        args, prefix_cache=False, restore_patience=0,
        max_pages_per_seq=max(
            4, (args.prompt_len + args.max_new_tokens) // args.page_size + 2))
    print(serve_cfg.describe())
    print(f"model: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype}) on {device_name(model.device)}")
    if model.device.type == "cuda":
        build.build_all()          # nvcc at first use: keep it out of timing
    warm = Engine(model, params, serve_cfg)   # first-call costs, untimed
    warm.submit(ServeRequest(prompt=np.zeros(args.page_size, np.int32),
                             max_new_tokens=2))
    warm.drain()
    warm.close()
    eng = Engine(model, params, serve_cfg)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        eng.submit(ServeRequest(
            prompt=rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new_tokens,
        ))
    ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if model.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        ctx = profile(activities=acts)
    with ctx as prof:
        t0 = time.perf_counter()
        results = eng.drain()
        dt = time.perf_counter() - t0
    if args.profile:
        print_profile(prof, dt)
    stats = eng.stats()
    total_tokens = sum(len(r.tokens) for r in results.values())
    n_done = sum(1 for r in results.values() if r.status == "done")
    print(f"completed {n_done}/{args.requests} requests, {total_tokens} "
          f"tokens in {dt:.3f}s ({total_tokens / dt:.1f} tok/s on "
          f"{device_name(model.device)})")
    finished = [r for r in results.values() if r.status == "done"]
    if finished:
        ttfts = sorted(r.ttft for r in finished)
        tpots = sorted(r.tpot for r in finished)
        mid = len(finished) // 2
        print(f"  latency: TTFT p50 {ttfts[mid] * 1e3:.1f} ms / max "
              f"{ttfts[-1] * 1e3:.1f} ms, TPOT p50 {tpots[mid] * 1e3:.1f} ms "
              f"(commit-point stamps)")
    print("scheduler (policy plane) counters:", stats["counters"])
    print("executor (data plane): context switches:", stats["switch_stats"])
    c = eng.counters
    print(f"  page-table delta uploads: {c.get('ptab_rows_uploaded')} rows "
          f"in {c.get('ptab_syncs')} syncs over {eng.scheduler.step_i} steps")
    print(f"  kernel dispatch: {c.get('kernel_dispatches')} kernel / "
          f"{c.get('ref_path_dispatches')} plain-path compute steps")
    kp = eng.kv.k_pools
    print(f"  kv pools: dtype={kp.dtype} ({serve_cfg.kv_dtype}), "
          f"{2 * kp[:, 0].numel() * kp.element_size()} B/page across "
          f"{kp.shape[1]} frames")
    print(f"  fused decode horizon: mean "
          f"{c.get('decode_horizon') / max(c.get('decode_dispatches'), 1):.2f}"
          f" over {c.get('decode_dispatches')} dispatches, "
          f"{c.ratio('host_syncs', 'decode_tokens'):.3f} host syncs/token")
    print("pool:", stats["pool"])
    eng.close()


if __name__ == "__main__":
    main()
