"""The port's dry-run cases on a fake process group, for
``tests/test_torch_dryrun.py`` (not collected: no ``test_`` prefix).

    python tests/torch_dryrun_worker.py WORKDIR

As rank 0 of a fake 512-rank group (``launch/dryrun.start_fake_group``),
builds the port's case of every cell of ``jax_dryrun_reference``'s list
(nothing run) and records its kind, model FLOPs, every argument leaf's
global shape and dtype, and the serve state's placements and local
shapes; runs ``launch/dryrun.main`` on one cell, a skipped one and a
failing variant into ``WORKDIR/cells``; then, on a fake 8-rank group,
counts the collectives of the mesh training step of ``chip_smoke.py``'s
``mesh_train_check`` (granite-moe-1b-a400m at full width, 2 layers, f32,
(data 4, model 2), B 8 x S 512).  Writes ``WORKDIR/port.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time


def leaves(tree, prefix="") -> dict:
    """``{path: [global shape, dtype]}``: dict keys, NamedTuple fields
    and list indices joined by ``/`` (the names JAX's paths give)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return {prefix: [list(tree.shape), str(tree.dtype).removeprefix(
            "torch.")]}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def main(work: str) -> None:
    import torch.distributed as dist
    from jax_dryrun_reference import SUBSET
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import dryrun, op_cost, specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import SHAPES, ShapeConfig
    t0 = time.time()
    res = {"skip": {}, "variants": specs.VARIANTS, "batch_specs": {},
           "cases": {}, "placements": {}}
    dryrun.start_fake_group(512)
    cells = [(a, s, False, "2d") for a in ARCHS for s in SHAPES]
    cells += [(a, s, True, "2d") for a in SUBSET for s in SHAPES]
    cells += [(a, s, False, "flat") for a in SUBSET for s in SHAPES
              if SHAPES[s].kind != "train"]
    for arch in ARCHS:
        res["skip"][arch] = {s: specs.skip_reason(arch, s) for s in SHAPES}
        res["batch_specs"][arch] = {
            s: leaves(specs.train_batch_specs(get_config(arch), SHAPES[s]))
            for s in SHAPES}
    for arch, shape, multi, mode in cells:
        if specs.skip_reason(arch, shape):
            continue
        key = f"{arch}|{shape}|{int(multi)}|{mode}"
        case = specs.build_case(arch, shape,
                                dryrun._mesh_for(arch, shape, multi, mode),
                                mode)
        res["cases"][key] = {"kind": case.kind,
                             "flops": case.model_flops_per_step,
                             "leaves": leaves(case.args)}
        if case.kind != "train":
            state = case.args[2 if case.kind == "decode" else 3]
            mesh = state[0].device_mesh
            res["placements"][key] = {
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                **{name: [[str(p) for p in t.placements],
                          list(t.to_local().shape)]
                   for name, t in state._asdict().items()}}
    res["build_s"] = time.time() - t0
    dryrun.OUT_DIR = os.path.join(work, "cells")
    for argv in (["--arch", "qwen2-7b", "--shape", "decode_32k"],
                 ["--arch", "qwen2-7b", "--shape", "long_500k"],
                 ["--arch", "rwkv6-7b", "--shape", "train_4k", "--variant",
                  "remat_dots"]):
        dryrun.main(argv + ["--force"])
    dist.destroy_process_group()
    dryrun.start_fake_group(8)
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              num_layers=2, param_dtype="float32")
    case = specs.train_case(cfg, ShapeConfig("mesh", 512, 8, "train"),
                            make_host_mesh(4, 2, device="cpu"))
    costs, _ = op_cost.count(case.fn, *case.args)
    res["mesh_step"] = {"by_kind": costs.coll_by_kind,
                        "counts": costs.coll_counts,
                        "comm": dict(case.fn.comm),
                        "stats_b": op_cost.stat_bytes(2)}
    dist.destroy_process_group()
    res["seconds"] = time.time() - t0
    with open(os.path.join(work, "port.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
