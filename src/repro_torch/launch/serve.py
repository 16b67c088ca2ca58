"""Serving launcher on the card: ``python -m repro_torch.launch.serve [...]``.

Spins up the split serving engine (host Scheduler = policy plane, device
Executor = data plane with the CUDA kernels; see
``repro_torch/serve/engine.py``) with random weights from a seeded
``torch.Generator`` and reports the paper-aligned statistics: page faults,
context-switch bytes/cycles, page-table delta uploads, tokens/s on the
card.

The serving flags come from ``ServeConfig.add_args``: the default policy
serves, with the radix prefix cache (``--no-prefix-cache`` turns it off)
and partial restore on.  ``--prefix-len N`` preloads a
random N-token shared prefix and submits every request as a
``share_prefix`` fork of it (continuation prefill through the executor).
``--replicas N`` serves through a ``ReplicaRouter`` over N engines on the
one device (``--route-policy``: ``least_loaded`` or ``round_robin``);
the engines share one model and one weight set, each has its own pools,
page table and CUDA graphs, and each is preloaded with the prefix.

``--serve-mesh auto|N`` serves SPMD on a ('kv', 'hd') mesh of gloo ranks:
every rank runs this launcher with the same arguments, builds the same
model and engines (``--replicas`` too) on the mesh and drives the same
schedule, each holding its slice of the KV pools.  With no process group
started the launcher starts one, ``init_process_group("gloo",
init_method=--dist-init)``, with the rank and world size of ``RANK`` /
``WORLD_SIZE``: ``torchrun --standalone --nproc-per-node N -m
repro_torch.launch.serve --serve-mesh N ...`` sets them and the default
``env://`` rendezvous; ``--dist-init file:///path`` needs no TCP port.
On the card every rank takes ``cuda:{LOCAL_RANK % device_count()}`` (all
of them the one card of a one-card machine).  Only rank 0 prints the
statistics; a rank the mesh leaves out says so and returns.

The model is the arch's reduced config unless ``--full`` asks for the
published widths; ``--num-layers`` cuts depth only.  An audio arch
(``musicgen-large``) gets ``[plen, num_codebooks]`` codebook prompts, as
in the JAX launcher; a VLM (``qwen2-vl-7b``) serves text prompts (the
engine passes no vision embeddings, nor does the JAX engine).
Recurrent families
(``rwkv6-7b``, ``recurrentgemma-9b``) are refused before a model is built,
as the JAX launcher refuses them: they decode through the model's own
``prefill`` / ``decode_step``.  ``--device cpu``
runs the plain PyTorch versions of the kernels on the CPU.  The kernels
are built and one short request is served before the timed run, so
tokens/s and TTFT exclude the build and first-call costs; ``--profile``
traces the timed run (the engine's or the router's drain, torch.profiler)
and prints device time by kernel and the device's busy and idle shares.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import math
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import build
from repro_torch.launch.mesh import rank_device, start_group
from repro_torch.models import build_model
from repro_torch.serve import Engine, ReplicaRouter, ServeConfig, ServeRequest
from repro_torch.serve.engine import RECURRENT_FAMILIES, RECURRENT_REFUSAL


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


def main(argv: list[str] | None = None) -> int:
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
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="preload a shared prefix of this many tokens; "
                         "requests fork from it (continuation prefill)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engines behind the ReplicaRouter on the one "
                         "device: N Scheduler+Executor pairs (each with its "
                         "own KV pools, page table and graphs) over one "
                         "weight set, fed from one global admission queue; "
                         "1 = the plain engine")
    ap.add_argument("--route-policy", default="least_loaded",
                    choices=ReplicaRouter.POLICIES,
                    help="replica placement policy (fork affinity is "
                         "always enforced on top: COW forks stay on a "
                         "prefix-holding replica)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve run with torch.profiler and print "
                         "device time by kernel and the device busy share")
    ap.add_argument("--print-tokens", action="store_true",
                    help="print each request's generated tokens")
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's rendezvous on a serve mesh "
                         "(init_method of init_process_group): env:// "
                         "under torchrun, or file:///path")
    ServeConfig.add_args(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    if cfg.family in RECURRENT_FAMILIES:
        raise SystemExit(f"{args.arch}: {RECURRENT_REFUSAL}")
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    serve_cfg = ServeConfig.from_args(args, max_pages_per_seq=max(
        4, (args.prefix_len + args.prompt_len + args.max_new_tokens)
        // args.page_size + 2))
    if args.serve_mesh == "off":
        return serve(args, cfg, serve_cfg, args.device, None)
    started = start_group(args.dist_init, f"--serve-mesh {args.serve_mesh}",
                          "repro_torch.launch.serve --serve-mesh N")
    try:
        import torch.distributed as dist
        device = rank_device(args.device)
        mesh = serve_cfg.build_mesh(cfg, device=device)
        if mesh.get_coordinate() is None:
            print(f"rank {dist.get_rank()}: idle, the {mesh.size()}-rank "
                  f"serve mesh leaves this rank out")
            return 0
        # every rank serves; rank 0 alone prints
        quiet = (contextlib.redirect_stdout(io.StringIO())
                 if dist.get_rank() else contextlib.nullcontext())
        with quiet:
            return serve(args, cfg, serve_cfg, device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def serve(args, cfg, serve_cfg, device, mesh) -> int:
    """Build the model and engines (on ``mesh`` when given), serve the
    workload and print the statistics."""
    model = build_model(cfg, device=device)
    params = model.init(args.seed)
    print(serve_cfg.describe())
    if mesh is not None:
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        print(f"serve mesh: {shape} over {mesh.size()} of "
              f"{torch.distributed.get_world_size()} ranks (KV pools split, "
              "page table whole on every rank)")
    print(f"model: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype}) on {device_name(model.device)}")
    if model.device.type == "cuda":
        build.build_all()          # nvcc at first use: keep it out of timing
    # a prompt's trailing shape: [plen, K] codebook streams for audio
    tok_shape = model.token_shape
    warm = Engine(model, params, serve_cfg, mesh=mesh)   # untimed
    warm.submit(ServeRequest(
        prompt=np.zeros((args.page_size,) + tok_shape, np.int32),
        max_new_tokens=2))
    warm.drain()
    warm.close()
    engines = [Engine(model, params, serve_cfg, mesh=mesh)
               for _ in range(max(1, args.replicas))]
    eng = engines[0]
    router = None
    if args.replicas > 1:
        router = ReplicaRouter(
            [e.as_replica(i) for i, e in enumerate(engines)],
            policy=args.route_policy)
        print(f"replica router: {args.replicas} replicas "
              f"({args.route_policy}; each {args.num_pages} frames, "
              f"max_batch {args.max_batch}) over one weight set")
    if model.device.type == "cuda":
        print(f"  {len(engines)} engine(s) built: "
              f"{torch.cuda.memory_allocated(model.device) / 1e9:.2f} GB "
              "allocated on the card")
    rng = np.random.default_rng(args.seed)
    share = args.prefix_len > 0
    if share:
        prefix = rng.integers(0, cfg.vocab_size, size=args.prefix_len)
        for e in engines:      # every replica can parent COW forks
            e.preload_prefix(prefix)
    front = router if router is not None else eng
    for _ in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        front.submit(ServeRequest(
            prompt=rng.integers(0, cfg.vocab_size,
                                size=(plen,) + tok_shape).astype(np.int32),
            max_new_tokens=args.max_new_tokens, share_prefix=share,
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
        results = front.drain()
        dt = time.perf_counter() - t0
    if args.profile:
        print_profile(prof, dt)
    stats = eng.stats()
    total_tokens = sum(len(r.tokens) for r in results.values())
    n_done = sum(1 for r in results.values() if r.status == "done")
    print(f"completed {n_done}/{args.requests} requests, {total_tokens} "
          f"tokens in {dt:.3f}s ({total_tokens / dt:.1f} tok/s on "
          f"{device_name(model.device)})")
    if args.print_tokens:
        for rid in sorted(results):
            print(f"tokens {rid}: {[int(t) for t in np.ravel(results[rid].tokens)]}")
    finished = [r for r in results.values() if r.status == "done"]
    if finished:
        ttfts = sorted(r.ttft for r in finished)
        tpots = sorted(r.tpot for r in finished)
        mid = len(finished) // 2
        print(f"  latency: TTFT p50 {ttfts[mid] * 1e3:.1f} ms / max "
              f"{ttfts[-1] * 1e3:.1f} ms, TPOT p50 {tpots[mid] * 1e3:.1f} ms "
              f"(commit-point stamps)")
    if router is not None:
        r = router.counters
        print(f"router: {r.get('placements')} placements ("
              + ", ".join(str(r.get(f"placements_replica{i}"))
                          for i in range(args.replicas))
              + f" per replica), {r.get('migrations_declined')} migrations "
              f"declined, {r.get('prefix_routed')} prefix-routed, "
              f"{r.get('restore_migrations')} restore migrations, "
              f"{r.get('migration_aborts')} aborts, "
              f"{r.get('cross_replica_queue_waits')} queue-wait steps")
        print("router counters:", router.stats()["router"]["counters"])
        print("router global pages:", router.global_page_report())
        router.check_invariants()
        print("-- replica 0 detail --")
    print("scheduler (policy plane) counters:", stats["counters"])
    print("executor (data plane): context switches:", stats["switch_stats"])
    c = eng.counters
    print(f"  page-table delta uploads: {c.get('ptab_rows_uploaded')} rows "
          f"in {c.get('ptab_syncs')} syncs over {eng.scheduler.step_i} steps")
    print(f"  kernel dispatch: {c.get('kernel_dispatches')} kernel / "
          f"{c.get('ref_path_dispatches')} plain-path compute steps")
    if serve_cfg.aot_buckets:
        print(f"  aot prefill: {c.get('aot_hits')} hits / "
              f"{c.get('aot_misses')} misses, "
              f"{c.get('bucket_pad_tokens')} pad tokens")
    kp = eng.kv.k_pools
    per_page = 2 * kp.shape[0] * math.prod(kp.shape[2:]) * kp.dtype.itemsize
    print(f"  kv pools: dtype={kp.dtype} ({serve_cfg.kv_dtype}), "
          f"{per_page} B/page across {kp.shape[1]} frames")
    print(f"  fused decode horizon: mean "
          f"{c.get('decode_horizon') / max(c.get('decode_dispatches'), 1):.2f}"
          f" over {c.get('decode_dispatches')} dispatches, "
          f"{c.ratio('host_syncs', 'decode_tokens'):.3f} host syncs/token")
    print(f"  continuation: {c.get('forked_admissions')} forks in "
          f"{c.get('fork_batches')} batches, {c.get('prefix_hits')} prefix "
          f"hits, {c.get('partial_restores')} partial restores, "
          f"{c.get('continuation_prefill_tokens')} continuation tokens")
    print("pool:", stats["pool"])
    for e in engines:
        e.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
