"""The JAX package's side of ``tests/test_torch_serve_mesh.py`` (not
collected).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/jax_serve_mesh_reference.py WORKDIR

Serves each scenario of ``torch_serve_mesh_worker.SCENARIOS`` marked
``jax`` through JAX's ``Engine`` on the reduced qwen2-7b with the weights
of ``WORKDIR/weights.npz``, as ``tests/test_serve_sharded.py``'s fixture
builds it (``use_kernels=False``), once on JAX's serve mesh
(``make_host_serve_mesh``: (kv 2, hd 2) over the 4 forced host devices)
and once on one device.  Writes ``WORKDIR/jax_serve.json``: per scenario
and placement, tokens, counters and switch stats.
"""

from __future__ import annotations

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_serve_mesh_worker as W
from repro.configs import get_config
from repro.launch.mesh import make_host_serve_mesh
from repro.models import build_model
from repro.serve import Engine, ServeConfig, ServeRequest


def main(argv: list[str]) -> None:
    work = pathlib.Path(argv[0])
    cfg = get_config("qwen2-7b", reduced=True)
    model = build_model(cfg, remat=False)
    params = jax.tree_util.tree_map(
        jnp.asarray, W.unflatten(np.load(work / "weights.npz")))
    mesh = make_host_serve_mesh(cfg.num_kv_heads, cfg.head_dim)
    out = {"mesh_shape": [int(mesh.shape[a]) for a in mesh.axis_names],
           "mesh_axes": list(mesh.axis_names), "runs": {}}
    for name, sc in W.SCENARIOS.items():
        if not sc.get("jax"):
            continue
        for where, m in (("mesh", mesh), ("single", None)):
            eng, tokens, _ = W.scenario_run(name, Engine, ServeRequest,
                                            ServeConfig, model, params,
                                            cfg.vocab_size, mesh=m)
            out["runs"][f"{name}/{where}"] = W.summary(eng, tokens)
            eng.close()
    (work / "jax_serve.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
