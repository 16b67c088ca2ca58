"""The JAX package's side of ``tests/test_torch_train_mesh.py`` (not
collected).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/jax_train_mesh_reference.py WORKDIR TAG [RUN ...]

Trains each named run of ``torch_train_mesh_worker.RUNS`` as JAX's dry-run
builds its step (``src/repro/launch/specs.py:133-153``): the model with
``make_shard_hook``, ``make_train_step(grad_shardings=param_shardings)``
jitted with ``param_shardings`` / ``opt_shardings`` / ``batch_shardings``
on a ('data', 'model') mesh of the 4 forced host devices, from the
weights of ``WORKDIR/weights_<arch>.npz`` on the same stream.  Writes
``WORKDIR/jax_<TAG>.json`` (each run's metrics per step) and
``WORKDIR/jax_<TAG>.npz`` (each run's final parameters, flattened).
A RUN named ``compress`` instead runs ``compressed_psum_tree`` over
'data' of a (data 4, model 1) mesh on the worker's replicated gradients
and writes ``WORKDIR/jax_compress.json``.
"""

from __future__ import annotations

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_train_mesh_worker as W
from repro.configs import get_config
from repro.data import SyntheticLMStream
from repro.launch.mesh import compat_make_mesh, use_mesh
from repro.launch.sharding import (batch_shardings, make_shard_hook,
                                   opt_shardings, param_shardings)
from repro.models import build_model
from repro.models.config import ShapeConfig
from repro.optim import AdamWConfig, adamw_init
from repro.optim.compression import compressed_psum_tree, init_error_state
from repro.train import make_train_step


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def run_one(work: pathlib.Path, run: dict):
    cfg = get_config(run["arch"], reduced=True)
    mesh = compat_make_mesh(run["mesh"], ("data", "model"))
    model = build_model(cfg, use_kernels=False, remat=True,
                        shard=make_shard_hook(mesh), **run.get("model", {}))
    params = jax.tree_util.tree_map(
        jnp.asarray, W.unflatten(np.load(work / f"weights_{run['arch']}.npz")))
    opt = adamw_init(params)
    stream = SyntheticLMStream(cfg, ShapeConfig("t", W.SEQ, W.BATCH,
                                                "train"))
    batch0 = stream.batch(0)
    p_sh = param_shardings(params, mesh)
    o_sh = opt_shardings(params, mesh)
    b_sh = batch_shardings(batch0, mesh)
    step = make_train_step(model, AdamWConfig(**W.STEP_OPT),
                           accum_steps=run["accum"], donate=False,
                           grad_shardings=p_sh)
    inner = step.__wrapped__ if hasattr(step, "__wrapped__") else step
    metrics = []
    with use_mesh(mesh):
        fn = jax.jit(inner, in_shardings=(p_sh, o_sh, b_sh),
                     out_shardings=(p_sh, o_sh, None))
        params = jax.device_put(params, p_sh)
        opt = jax.device_put(opt, o_sh)
        for s in range(run["steps"]):
            params, opt, met = fn(params, opt, stream.batch(s))
            metrics.append({k: float(v) for k, v in met.items()})
    return metrics, flatten(jax.tree_util.tree_map(np.asarray, params))


def compress(work: pathlib.Path) -> None:
    mesh = compat_make_mesh((4, 1), ("data", "model"))
    g = {k: jnp.asarray(v)
         for k, v in W.compress_grads(0, 0, 4, True).items()}
    mean, err = compressed_psum_tree(g, init_error_state(g), mesh)
    (work / "jax_compress.json").write_text(json.dumps(
        {k: dict(mean=np.asarray(mean[k]).tolist(),
                 err=np.asarray(err[k]).tolist()) for k in mean}))


def main(argv: list[str]) -> None:
    work, tag, names = pathlib.Path(argv[0]), argv[1], argv[2:]
    out, arrays = {}, {}
    for name in names:
        if name == "compress":
            compress(work)
            continue
        metrics, flat = run_one(work, W.RUNS[name])
        out[name] = metrics
        arrays.update({f"{name}|{k}": v for k, v in flat.items()})
    (work / f"jax_{tag}.json").write_text(json.dumps(out))
    np.savez(work / f"jax_{tag}.npz", **arrays)


if __name__ == "__main__":
    main(sys.argv[1:])
