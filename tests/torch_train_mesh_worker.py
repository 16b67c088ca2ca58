"""One gloo rank of ``tests/test_torch_train_mesh.py`` (not collected).

    python tests/torch_train_mesh_worker.py RANK WORLD STORE_FILE WORKDIR

Joins a gloo process group through the file rendezvous ``STORE_FILE``
(timeout 60 s) and, on ('data', 'model') meshes of the 4 ranks:

  * trains every run of :data:`RUNS` through the port's
    ``make_train_step(grad_shardings=param_shardings(...))`` from the
    weights of ``WORKDIR/weights_<arch>.npz`` (JAX's ``init``, carried
    over by ``params_from_jax``), on ``SyntheticLMStream`` batches that
    the mesh ``make_global_batch`` splits; records each step's metrics,
    the final local slices of the parameters and moments, and whether
    every local shape is the declared layout's;
  * trains granite-moe through ``Trainer(mesh=...)``, with a checkpoint
    and a resume;
  * saves a tree on (2, 2) and restores it onto (4, 1) and (1, 4);
  * runs ``compressed_psum_tree`` on replicated and on per-rank
    gradients, and for 50 steps of error feedback;
  * redistributes a DTensor through the shard hook.

Writes ``WORKDIR/rank{RANK}.json`` and ``WORKDIR/rank{RANK}.npz``.  The
run definitions and the batch and weight helpers are shared with the test
and with ``tests/jax_train_mesh_reference.py``, which import this module;
its own imports are torch, numpy and the port.
"""

from __future__ import annotations

import datetime
import json
import pathlib
import sys

import numpy as np
import torch

#: B 8 x S 16, the optimizer of ``tests/test_torch_substrate.py``
BATCH, SEQ = 8, 16
STEP_OPT = dict(base_lr=1e-3, warmup_steps=2, total_steps=10)
FAMILIES = ("granite-8b", "granite-moe-1b-a400m", "qwen2-vl-7b",
            "musicgen-large", "rwkv6-7b", "recurrentgemma-9b")


def _runs() -> dict[str, dict]:
    runs = {}
    for arch in FAMILIES:
        for accum, steps in ((1, 3), (2, 2)):
            if accum == 2 and arch == "qwen2-vl-7b":
                continue        # [3, B, S] positions do not split
            runs[f"{arch}/2x2/a{accum}"] = dict(
                arch=arch, mesh=(2, 2), accum=accum, steps=steps)
    # the dense dispatch's router loss is a product of batch means
    runs["granite-moe-1b-a400m/2x2/a1/dense"] = dict(
        arch="granite-moe-1b-a400m", mesh=(2, 2), accum=1, steps=3,
        model=dict(moe_dispatch="dense"))
    for arch in ("granite-8b", "granite-moe-1b-a400m"):
        for mesh in ((4, 1), (1, 4)):
            for accum, steps in ((1, 3), (2, 2)):
                runs[f"{arch}/{mesh[0]}x{mesh[1]}/a{accum}"] = dict(
                    arch=arch, mesh=mesh, accum=accum, steps=steps)
    return runs


#: name -> arch, (data, model), accum_steps, steps and the model's other
#: arguments (``model``)
RUNS = _runs()
#: the launcher on a (data 1, model 2) mesh of the 4 ranks: ranks 2 and 3
#: are left out
IDLE_LAUNCH = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
               "--seq-len", "16", "--global-batch", "8", "--steps", "1",
               "--data", "1", "--model", "2"]
#: the Trainer's run: 3 steps, a checkpoint at 2, then a resume to 4
TRAINER = dict(arch="granite-moe-1b-a400m", mesh=(2, 2), steps=3,
               resume_to=4, ckpt_every=2)
#: the compression cases: 50 steps of error feedback on 4 ranks
COMPRESS_STEPS = 50


def unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def compress_grads(step: int, rank: int, world: int, replicated: bool):
    """The gradients of the compression cases: two leaves, each rank's
    own unless ``replicated``."""
    rng = np.random.default_rng((5, step, 0 if replicated else rank))
    return {"a": rng.normal(size=(7, 33)).astype(np.float32),
            "b": (rng.normal(size=(64,)) * 1e-3).astype(np.float32)}


def main(argv: list[str]) -> None:
    import torch.distributed as dist
    rank, world, store, work = (int(argv[0]), int(argv[1]), argv[2],
                                pathlib.Path(argv[3]))
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    out, arrays = {"runs": {}}, {}
    try:
        meshes = mesh_cache()
        for name, run in RUNS.items():
            res, arr = train_run(work, meshes, run)
            out["runs"][name] = res
            arrays.update({f"{name}|{k}": v for k, v in arr.items()})
        out["trainer"] = trainer_run(work, meshes)
        out["restore"], arr = restore_run(work, meshes)
        arrays.update({f"restore|{k}": v for k, v in arr.items()})
        out["compress"] = compress_run(meshes, rank, world)
        out["hook"] = hook_run(meshes)
        out["idle_launch"] = idle_launch(work, rank)
    finally:
        (work / f"rank{rank}.json").write_text(json.dumps(out))
        np.savez(work / f"rank{rank}.npz", **arrays)
        dist.destroy_process_group()


def mesh_cache() -> dict:
    """Every mesh of the runs, each made once (a collective of all ranks),
    in the same order on every rank."""
    from repro_torch.launch.mesh import make_host_mesh
    return {shape: make_host_mesh(*shape, device="cpu")
            for shape in ((2, 2), (4, 1), (1, 4))}


def spec_local_shape(shape, spec, extents) -> list[int]:
    """The local shape of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        for a in axes:
            out[d] //= extents[a]
    return out


def train_run(work, meshes, run):
    from repro_torch import data
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig, adamw_init, tree_leaves
    from repro_torch.train import make_train_step
    mesh = meshes[run["mesh"]]
    cfg = get_config(run["arch"], reduced=True)
    params = params_from_jax(
        unflatten(np.load(work / f"weights_{run['arch']}.npz")), cfg, "cpu")
    model = build_model(cfg, device="cpu", use_kernels=False,
                        shard=sh.make_shard_hook(mesh), **run.get("model", {}))
    p_sh = sh.param_shardings(params, mesh)
    o_sh = sh.opt_shardings(params, mesh)
    params = sh.shard_tree(params, p_sh)
    opt = adamw_init(params)
    opt = opt._replace(step=sh.shard_tree(opt.step, o_sh.step))
    step = make_train_step(model, AdamWConfig(**STEP_OPT),
                           accum_steps=run["accum"], grad_shardings=p_sh)
    s = data.SyntheticLMStream(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                               process=(0, 1))
    metrics, batch_ok = [], True
    for i in range(run["steps"]):
        batch = data.make_global_batch(s.batch(i), mesh)
        b_sh = sh.batch_shardings(batch, mesh)
        batch_ok &= all(batch[k].placements == b_sh[k].placements
                        for k in batch)
        params, opt, met = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in met.items()})
    ext = sh.mesh_extents(mesh)
    layout_ok = True
    arrays = {}
    for tree, shards, tag in ((params, p_sh, "p"), (opt.m, p_sh, "m"),
                              (opt.v, p_sh, "v")):
        for (name, x), s_ in zip(_named(tree), tree_leaves(shards)):
            layout_ok &= (tuple(x.placements) == s_.placements and list(
                x.to_local().shape) == spec_local_shape(x.shape, s_.spec,
                                                        ext))
            arrays[f"{tag}|{name}"] = x.to_local().numpy()
    return dict(metrics=metrics, layout_ok=bool(layout_ok),
                batch_ok=bool(batch_ok), step=int(opt.step.to_local()),
                coord=list(mesh.get_coordinate()),
                specs={n: list(map(_jsonable, s_.spec))
                       for (n, _), s_ in zip(_named(params),
                                             tree_leaves(p_sh))},
                comm=dict(step.comm)), arrays


def _jsonable(entry):
    return list(entry) if isinstance(entry, tuple) else entry


def _named(tree) -> list[tuple[str, object]]:
    """``(JAX leaf name, leaf)`` in ``tree_leaves`` order."""
    from repro_torch.checkpoint import leaf_paths
    return leaf_paths(tree)


def trainer_run(work, meshes) -> dict:
    """granite-moe through ``Trainer(mesh=...)``: 3 steps with a
    checkpoint at 2 (async) and the final one at 3, then a new
    ``Trainer`` that resumes at 3 and runs to 4."""
    from repro_torch import data
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer
    run = TRAINER
    mesh = meshes[run["mesh"]]
    cfg = get_config(run["arch"], reduced=True)
    weights = unflatten(np.load(work / f"weights_{run['arch']}.npz"))
    model = build_model(cfg, device="cpu", use_kernels=False,
                        shard=sh.make_shard_hook(mesh))
    # the JAX weights, not the seeded init, so the run equals the step's
    model.init = lambda seed: params_from_jax(weights, cfg, "cpu")
    s = data.SyntheticLMStream(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                               process=(0, 1))
    ckpt_dir = work / "trainer_ckpt"
    hist = []
    for total in (run["steps"], run["resume_to"]):
        tr = Trainer(model, AdamWConfig(**STEP_OPT), ckpt_dir=str(ckpt_dir),
                     ckpt_every=run["ckpt_every"], mesh=mesh)
        params, opt, start = tr.init_or_restore(0)
        _, _, h = tr.run(params, opt, s.batch, start, total, log_every=1)
        hist.append(dict(start=start, history=h,
                         dtensor=type(params["embed"]).__name__))
    return dict(runs=hist, ckpts=sorted(p.name for p in ckpt_dir.iterdir()))


def restore_run(work, meshes):
    """A tree saved on (2, 2), restored onto (4, 1) and (1, 4)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    from repro_torch.models import params_from_jax
    from repro_torch.optim import tree_leaves
    cfg = get_config("granite-8b", reduced=True)
    whole = params_from_jax(
        unflatten(np.load(work / "weights_granite-8b.npz")), cfg, "cpu")
    src = sh.shard_tree(whole, sh.param_shardings(whole, meshes[(2, 2)]))
    d = work / "restore_ckpt"
    ckpt.save(str(d), 7, src)
    res, arrays = {}, {}
    for shape in ((4, 1), (1, 4)):
        target_sh = sh.param_shardings(whole, meshes[shape])
        got = ckpt.restore(str(d), 7, whole, shardings=target_sh)
        ok = True
        for (name, x), s_, w in zip(_named(got), tree_leaves(target_sh),
                                    tree_leaves(whole)):
            ok &= (tuple(x.placements) == s_.placements and torch.equal(
                x.to_local(), ops.local_slice(w, meshes[shape],
                                              s_.placements)))
            arrays[f"{shape[0]}x{shape[1]}|{name}"] = x.to_local().numpy()
        res[f"{shape[0]}x{shape[1]}"] = bool(ok)
    return res, arrays


def compress_run(meshes, rank, world) -> dict:
    """``compressed_psum_tree`` over 'data' of the (4, 1) mesh: the
    replicated case's bytes, the per-rank case's values, and 50 steps of
    error feedback against the true mean."""
    from repro_torch.optim.compression import (compressed_psum_tree,
                                               init_error_state)
    mesh = meshes[(4, 1)]

    def tt(tree):
        return {k: torch.from_numpy(v) for k, v in tree.items()}
    out = {}
    for case in ("replicated", "distinct"):
        g = tt(compress_grads(0, rank, world, case == "replicated"))
        mean, err = compressed_psum_tree(g, init_error_state(g), mesh)
        out[case] = {k: dict(mean=mean[k].numpy().tolist(),
                             err=err[k].numpy().tolist())
                     for k in mean}
    for case in ("replicated", "distinct"):
        err, acc_hat, acc_true = None, 0.0, 0.0
        for step in range(COMPRESS_STEPS):
            rep = case == "replicated"
            g = tt(compress_grads(step + 1, rank, world, rep))
            err = init_error_state(g) if err is None else err
            mean, err = compressed_psum_tree(g, err, mesh)
            acc_hat = acc_hat + mean["a"].numpy()
            acc_true = acc_true + np.mean(
                [compress_grads(step + 1, r, world, rep)["a"]
                 for r in range(world)], axis=0)
        out[f"feedback_{case}"] = dict(
            gap=float(np.abs(acc_hat - acc_true).max()),
            scale=float(np.abs(acc_true).max()))
    return out


def idle_launch(work, rank) -> str:
    """The launcher on the group already started: ranks 0 and 1 train on
    (data 1, model 2), ranks 2 and 3 are idle; its standard output."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(IDLE_LAUNCH + ["--ckpt-dir", str(work / "idle_ckpt")])
    return buf.getvalue()


def hook_run(meshes) -> dict:
    """The shard hook on a DTensor of the (2, 2) mesh: activations and
    logits redistributed to JAX's specs; a plain tensor left as it is."""
    from torch.distributed.tensor import Replicate
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    mesh = meshes[(2, 2)]
    hook = sh.make_shard_hook(mesh)
    full = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    x = ops.shard_tensor(full, mesh, (Replicate(), Replicate()))
    out = {}
    for name, t in (("act_btd", x), ("act_btd_nosp", x),
                    ("logits", x), ("other", x)):
        y = hook(t, name)
        out[name] = dict(placements=[repr(p) for p in y.placements],
                         local=list(y.to_local().shape),
                         equal=bool(torch.equal(ops.unshard(y), full)))
    out["plain_same"] = hook(full, "act_btd") is full
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
