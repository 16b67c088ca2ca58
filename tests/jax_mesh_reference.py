"""The JAX package's side of ``tests/test_torch_mesh.py`` (not collected).

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \
        python tests/jax_mesh_reference.py WORKDIR

Writes ``WORKDIR/jax_factor.json``: ``make_production_mesh`` and
``make_serve_mesh`` shapes (single and multi-pod, several
``model_size``s; ``"ValueError"`` where it raises),
``make_host_serve_mesh`` shapes for 1-8 devices, and ``kv_partition_axes``
of every such mesh over the (Hkv, D) grid of ``WORKDIR/grid.json``; and
``WORKDIR/jax_out.npz``: each case of ``WORKDIR/cases.json`` marked
``jax`` through JAX's own ``*_sharded`` wrapper on
``make_host_serve_mesh(2, 16, num_devices=4)``, a (kv 2, hd 2) mesh (the
pair copies as two calls).
"""

from __future__ import annotations

import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops
from repro.launch.mesh import (kv_partition_axes, make_host_serve_mesh,
                               make_production_mesh, make_serve_mesh)

MODEL_SIZES = (16, 8, 4, 2)


def factorizations(grid) -> dict:
    serve, host, parts = {}, {}, {}
    meshes = []
    for hkv, d in grid:
        for pod in (False, True):
            for ms in MODEL_SIZES:
                key = f"{hkv},{d},{int(pod)},{ms}"
                try:
                    m = make_serve_mesh(hkv, d, multi_pod=pod, model_size=ms)
                except ValueError:
                    serve[key] = "ValueError"
                    continue
                serve[key] = [list(m.devices.shape), list(m.axis_names)]
                meshes.append(m)
        for n in range(1, 9):
            m = make_host_serve_mesh(hkv, d, num_devices=n)
            host[f"{hkv},{d},{n}"] = list(m.devices.shape)
            meshes.append(m)
    for m in meshes:
        ext = ",".join(f"{a}={s}" for a, s in m.shape.items())
        for hkv, d in grid:
            parts[f"{ext}|{hkv},{d}"] = list(kv_partition_axes(m, hkv, d))
    prod = {}
    for pod in (False, True):
        m = make_production_mesh(multi_pod=pod)
        prod[str(int(pod))] = [list(m.devices.shape), list(m.axis_names)]
    return {"serve": serve, "host": host, "partition": parts,
            "production": prod}


def run_case(mesh, case: dict, inputs) -> dict:
    cid, op, kw = case["id"], case["op"], dict(case.get("kw", {}))
    a = {n: jnp.asarray(inputs[f"{cid}/{n}"]) for n in case["args"]}
    if op == "copy":
        return {"out0": ops.paged_copy_sharded(
            a["src"], a["pool"], a["page_table"], a["lens"], mesh=mesh, **kw)}
    if op == "copy_at":
        return {"out0": ops.paged_copy_at_sharded(
            a["src"], a["pool"], a["page_table"], a["starts"], a["lens"],
            mesh=mesh, **kw)}
    if op in ("copy_kv", "copy_kv_at"):
        extra = (a["starts"],) if op == "copy_kv_at" else ()
        fn = (ops.paged_copy_at_sharded if extra else ops.paged_copy_sharded)
        return {f"out{i}": fn(a[f"{x}_src"], a[f"{x}_pool"], a["page_table"],
                              *extra, a["lens"], mesh=mesh, **kw)
                for i, x in enumerate("kv")}
    if op == "decode":
        return {"out0": ops.paged_decode_attention_sharded(
            a["q"], a["k_pool"], a["v_pool"], a["page_table"], a["lens"],
            mesh=mesh, **kw)}
    if op == "prefill":
        return {"out0": ops.paged_prefill_attention_sharded(
            a["q"], a["k_pool"], a["v_pool"], a["page_table"], a["starts"],
            mesh=mesh, **kw)}
    if op == "flash":
        return {"out0": ops.flash_attention_sharded(
            a["q"], a["k"], a["v"], mesh=mesh, causal=True, **kw)}
    raise ValueError(op)


def main(work: pathlib.Path) -> None:
    grid = [tuple(g) for g in json.loads((work / "grid.json").read_text())]
    (work / "jax_factor.json").write_text(json.dumps(factorizations(grid)))
    mesh = make_host_serve_mesh(2, 16, num_devices=4)
    assert dict(mesh.shape) == {"kv": 2, "hd": 2}, mesh.shape
    inputs = np.load(work / "inputs.npz")
    out = {}
    for case in json.loads((work / "cases.json").read_text()):
        if case.get("jax"):
            for k, v in run_case(mesh, case, inputs).items():
                out[f"{case['id']}/{k}"] = np.asarray(v)
    np.savez(work / "jax_out.npz", **out)


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]))
