"""JAX's dry-run cases, for ``tests/test_torch_dryrun.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \\
        python tests/jax_dryrun_reference.py OUT.json

Builds JAX's ``launch/specs.py`` case of every (arch x shape) on the
16 x 16 mesh (serve cells on the (kv, hd) view) and, for the archs of
:data:`SUBSET`, on the 2 x 16 x 16 mesh and the flat serve view, with
nothing lowered, and writes to OUT.json each case's kind, model FLOPs
and every argument leaf's shape and dtype, with ``skip_reason``,
``VARIANTS`` and ``train_batch_specs``.

    python tests/jax_dryrun_reference.py --ratios

(one CPU device) prints, for one reduced config of each family, the
port's ``op_cost`` count of the train step (``make_train_step``,
``remat=True``, f32, B 4 x S 64) over JAX's ``hlo_cost.analyze`` of the
same step compiled on one CPU device.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

#: the archs whose multi-pod and flat cells are held too (one of each
#: family; the flat view only changes serve cells)
SUBSET = ("qwen2-7b", "granite-moe-1b-a400m", "recurrentgemma-9b",
          "rwkv6-7b", "musicgen-large", "qwen2-vl-7b")
#: the step of the FLOP ratios: one reduced config a family
RATIO_ARCHS = ("qwen2-7b", "granite-moe-1b-a400m", "qwen2-vl-7b",
               "musicgen-large", "rwkv6-7b", "recurrentgemma-9b")
RATIO_BATCH, RATIO_SEQ = 4, 64


def _name(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def leaves(tree) -> dict:
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_name(k) for k in path): [list(x.shape), str(x.dtype)]
            for path, x in flat}


def cases(out: str) -> None:
    from repro.configs import ARCHS
    from repro.launch import specs
    from repro.launch.dryrun import _mesh_for
    from repro.launch.mesh import use_mesh
    from repro.models.config import SHAPES
    from repro.configs import get_config
    t0 = time.time()
    res = {"skip": {}, "variants": specs.VARIANTS, "batch_specs": {},
           "cases": {}}
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
        mesh = _mesh_for(arch, shape, multi, mode)
        with use_mesh(mesh):
            case = specs.build_case(arch, shape, mesh, mode)
        res["cases"][key] = {"kind": case.kind,
                             "flops": case.model_flops_per_step,
                             "leaves": leaves(case.args)}
    res["seconds"] = time.time() - t0
    with open(out, "w") as f:
        json.dump(res, f)


def ratios() -> dict:
    """``{arch: (port total, JAX total, port matmul)}`` of the reduced
    train step (see the module docstring)."""
    import jax
    import torch
    from repro.configs import get_config as jax_config
    from repro.launch import hlo_cost
    from repro.models import build_model as jax_build
    from repro.optim import AdamWConfig as JaxAdamW
    from repro.optim import adamw_init as jax_adamw_init
    from repro.train import make_train_step as jax_step
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    out = {}
    for arch in RATIO_ARCHS:
        jcfg = dataclasses.replace(jax_config(arch, reduced=True),
                                   param_dtype="float32")
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  param_dtype="float32")
        jm = jax_build(jcfg, use_kernels=False, remat=True)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = _batch(cfg)
        step = jax_step(jm, JaxAdamW())
        text = step.lower(jp, jax_adamw_init(jp), {
            k: jax.numpy.asarray(v) for k, v in batch.items()}
        ).compile().as_text()
        want = hlo_cost.analyze(text)["flops"]
        model = build_model(cfg, device="cpu", use_kernels=False, remat=True)
        params = model.init(0)
        got, _ = op_cost.count(make_train_step(model, AdamWConfig()),
                               params, adamw_init(params),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        out[arch] = (got.flops, want, got.matmul_flops)
    return out


def _batch(cfg) -> dict:
    """A seeded numpy batch of B x S for ``cfg``'s family."""
    import numpy as np
    rng = np.random.default_rng(0)
    b, s = RATIO_BATCH, RATIO_SEQ
    audio = cfg.family == "audio" and cfg.num_codebooks > 1
    shape = (b, s, cfg.num_codebooks) if audio else (b, s)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape, np.int32),
             "labels": rng.integers(0, cfg.vocab_size, shape, np.int32),
             "mask": np.ones((b, s), np.float32)}
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        batch["positions"] = np.stack([pos, pos, pos])
        batch["vision_embeds"] = rng.normal(
            size=(b, 4, cfg.d_model)).astype(np.float32)
    return batch


if __name__ == "__main__":
    if sys.argv[1:] == ["--ratios"]:
        for arch, (got, want, mm) in ratios().items():
            print(f"{arch}: op_cost {got:.6g} / hlo_cost {want:.6g} = "
                  f"{got / want:.4f} (op_cost matmul {mm:.6g})")
    else:
        cases(sys.argv[1])
