"""Multi-pod dry-run: run every (arch x shape x mesh) cell on ``meta``
tensors over a fake 256- or 512-rank process group (port of
``src/repro/launch/dryrun.py``).

For each cell:
  * build the ``meta`` inputs and the port's step with the production
    layouts (``launch/specs.py``);
  * run the step once on them as rank 0 of a fake process group
    (``torch.testing._internal.distributed.fake_pg``, backend ``"fake"``:
    collectives return at once and send nothing), where JAX lowers and
    compiles on 512 placeholder devices (``XLA_FLAGS``);
  * record its memory (``MemTracker``'s peak over the run above the
    arguments: does it fit the card's 80 GB?), its FLOPs and bytes and collective traffic
    (``launch/op_cost.py``, every collective as it dispatches) and the
    roofline (``launch/analysis.py``, H100 constants);
  * write the result to ``experiments/dryrun_torch/<cell>.json``
    (incremental: finished cells are skipped on a re-run; JAX's
    ``experiments/dryrun/`` is left alone).

Memory fields (JAX's names): ``argument_bytes`` are the local bytes of
the arguments on rank 0; ``temp_bytes`` the tracked peak of what the step
allocates above them (its outputs included); ``output_bytes`` the local
bytes of the outputs.  ``alias_bytes`` and ``generated_code_bytes`` are
null: eager PyTorch donates no buffer to an output and generates no code.
``trace_s`` (the time of the run) takes the place of ``lower_s`` /
``compile_s``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.costmodel import H100_HBM_BYTES
from repro_torch.launch import analysis, op_cost
from repro_torch.launch.mesh import make_production_mesh, make_serve_mesh
from repro_torch.launch.specs import build_case, skip_reason
from repro_torch.models.config import SHAPES

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def cell_path(arch: str, shape: str, mesh_name: str, serve_mode: str,
              variant: str | None = None) -> str:
    suffix = "" if serve_mode == "2d" else f"__{serve_mode}"
    if variant:
        suffix += f"__{variant}"
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh_name}{suffix}.json")


def start_fake_group(world_size: int) -> bool:
    """Start a fake process group of ``world_size`` ranks, this process
    rank 0, unless a group is started already; True when this call
    started it."""
    if dist.is_initialized():
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    return True


def _mesh_for(arch: str, shape: str, multi_pod: bool, serve_mode: str):
    if SHAPES[shape].kind == "train" or serve_mode == "flat":
        return make_production_mesh(multi_pod=multi_pod, device="cpu")
    cfg = get_config(arch)
    if cfg.family == "rwkv6":
        kv, hd = cfg.num_rwkv_heads, cfg.rwkv_head_size
    else:
        kv, hd = cfg.num_kv_heads, cfg.head_dim
    return make_serve_mesh(kv, hd, multi_pod=multi_pod, device="cpu")


def peak_above(trees, fn, *args):
    """``(fn(*args), the bytes its run holds at its peak above the tensors
    of trees)``, by ``MemTracker``.  The tracker is told of those tensors
    (a DTensor's local one) first: it would count a storage it first sees
    through a view made inside the run as an allocation."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_flatten
    tracker = MemTracker()
    tracker.track_external(*(
        x.to_local() if hasattr(x, "to_local") else x
        for x in tree_flatten(trees)[0] if isinstance(x, torch.Tensor)))

    def total(kind):
        return sum(v["Total"] for v in
                   tracker.get_tracker_snapshot(kind).values())
    with tracker:
        base = total("current")
        out = fn(*args)
    return out, total("peak") - base


def measure(case, chips: int) -> dict:
    """Run ``case`` once under the op counter and ``MemTracker``: the
    cell's ``memory``, ``cost``, ``collectives``, ``scopes`` and
    ``roofline`` fields (``chips``: the mesh's size), and ``trace_s``."""
    t0 = time.time()
    (costs, out), peak = peak_above(case.args, op_cost.count, case.fn,
                                    *case.args)
    trace_s = time.time() - t0
    la = costs.as_dict()
    coll = analysis.CollectiveStats(
        counts={k: int(v) for k, v in la["collective_counts"].items()},
        bytes_by_kind={k: int(v) for k, v in
                       la["collective_bytes_by_kind"].items()},
    )
    terms = analysis.roofline(
        {"flops": la["flops"], "bytes accessed": la["bytes"]},
        coll, chips=chips, model_flops=case.model_flops_per_step)
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": op_cost.tree_bytes(case.args),
            "output_bytes": op_cost.tree_bytes(out),
            "temp_bytes": peak,
            "generated_code_bytes": None,
            "alias_bytes": None,
        },
        "cost": {"flops": la["flops"], "bytes accessed": la["bytes"],
                 "matmul_flops": costs.matmul_flops},
        "collectives": {
            "counts": coll.counts,
            "bytes_by_kind": coll.bytes_by_kind,
            "total_bytes_per_device": coll.total_bytes,
        },
        "scopes": {
            "bytes": la["bytes_by_scope"],
            "flops": la["flops_by_scope"],
        },
        "roofline": terms.to_dict(),
    }


def run_cell(arch: str, shape: str, multi_pod: bool, force: bool = False,
             serve_mode: str = "2d", variant: str | None = None) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    path = cell_path(arch, shape, mesh_name, serve_mode, variant)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    reason = skip_reason(arch, shape)
    result: dict = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "serve_mode": serve_mode, "variant": variant,
        "chips": 512 if multi_pod else 256,
    }
    if reason:
        result["status"] = "skipped"
        result["reason"] = reason
        _write(path, result)
        return result
    try:
        mesh = _mesh_for(arch, shape, multi_pod, serve_mode)
        case = build_case(arch, shape, mesh, serve_mode, variant)
        result.update({"status": "ok", "kind": case.kind,
                       **measure(case, mesh.size())})
    except Exception as e:  # a failing cell is a bug — record it loudly
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    _write(path, result)
    return result


def _write(path: str, result: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)


def memory_per_chip(r: dict) -> int:
    """A cell's bytes a rank: its arguments plus the step's peak."""
    return (r["memory"]["argument_bytes"] or 0) + (
        r["memory"]["temp_bytes"] or 0)


def summarize(results: list[dict]) -> None:
    """One row a cell: status, dominant term, bound, MFU at the roofline,
    memory a rank in GB and whether it fits the card's 80 GB."""
    print(f"\n{'cell':52s} {'status':8s} {'dom':10s} "
          f"{'bound':>9s} {'MFU@roof':>8s} {'mem/chip':>9s} fits")
    for r in results:
        cell = f"{r['arch']}x{r['shape']}x{r['mesh']}"
        if r["status"] != "ok":
            print(f"{cell:52s} {r['status']:8s} {r.get('reason', r.get('error', ''))[:60]}")
            continue
        t = r["roofline"]
        bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
        mem = memory_per_chip(r)
        print(f"{cell:52s} {r['status']:8s} {t['dominant']:10s} "
              f"{analysis.fmt_seconds(bound):>9s} "
              f"{t['roofline_fraction']:8.2%} {mem / 1e9:8.2f}G "
              f"{'yes' if mem <= H100_HBM_BYTES else 'no'}")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--serve-mode", choices=("2d", "flat"), default="2d",
                    help="flat = baseline 1-D model axis for serve cells")
    ap.add_argument("--variant", default=None,
                    help="perf-iteration variant (see specs.VARIANTS)")
    args = ap.parse_args(argv)

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    started = start_fake_group(512 if any(meshes) else 256)
    results = []
    try:
        for multi in meshes:
            for arch, shape in cells:
                r = run_cell(arch, shape, multi, force=args.force,
                             serve_mode=args.serve_mode,
                             variant=args.variant)
                results.append(r)
                status = r["status"]
                extra = ""
                if status == "ok":
                    extra = (f"trace={r['trace_s']}s "
                             f"dom={r['roofline']['dominant']}")
                elif status == "error":
                    extra = r["error"][:100]
                print(f"[{status:7s}] {arch} x {shape} x {r['mesh']} {extra}",
                      flush=True)
        summarize(results)
    finally:
        if started:
            dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
