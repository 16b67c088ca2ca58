"""Checkpointing with atomic commits, async save and auto-resume (port of
``src/repro/checkpoint/checkpoint.py``, with its directory layout):

  * SAVE: one ``<leaf name>.npy`` a leaf under ``.tmp_step_<n>``, a
    ``manifest.json`` with the step and each leaf's shape and dtype, and
    the temp directory ``os.rename``d to ``step_<n>`` last: a reader never
    sees a partial checkpoint.  Leaf names are JAX's (:func:`leaf_paths`),
    so either package finds the other's leaves by name.
  * bf16 without ``ml_dtypes``: numpy has no bfloat16, so a bf16 leaf is
    stored as its ``uint16`` bits with ``"bfloat16"`` in the manifest.  A
    bf16 ``.npy`` that the JAX package wrote loads as ``|V2`` where
    ``ml_dtypes`` is absent and as ``bfloat16`` where it is present;
    :func:`restore` reads all three forms.
  * ASYNC: ``save_async`` copies every leaf to host memory synchronously
    (a copy even on the CPU, so a later in-place change cannot reach the
    writer) and writes in a daemon thread, overlapping I/O with the next
    steps.
  * RESTORE: :func:`latest_step` scans the directory; :func:`restore` maps
    the files back onto the structure of a target tree, each leaf on its
    target leaf's device (or on ``device``).
  * RETENTION: the ``keep`` newest checkpoints survive
    :func:`garbage_collect`.
  * MESHES: a tree of ``DTensor`` leaves (a mesh's ranks each holding its
    slices) is saved whole, in the same layout and names: every rank of
    the mesh gathers each leaf (one all-gather a leaf, on the calling
    thread, in leaf order), the mesh's first rank alone writes, and the
    others wait for it (a barrier; ``AsyncCheckpointer`` waits in
    :meth:`~AsyncCheckpointer.wait`, so its writer thread runs no
    collective).  ``restore(..., shardings=...)`` reads the whole leaves
    and keeps each rank's slice under the target layouts, whatever mesh
    wrote them (JAX's elastic reshard on load).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.optim.adamw import tree_leaves, tree_unflatten


def _mesh_of(leaves) -> Any:
    """The mesh of the first ``DTensor`` among ``leaves``, or None."""
    return next((x.device_mesh for x in leaves if ops.is_dtensor(x)), None)


def _gathered(leaves) -> list:
    """Each leaf whole (``ops.whole``: one all-gather over its mesh a
    split ``DTensor``, in leaf order)."""
    return [ops.whole(x) for x in leaves]


def _is_writer(mesh) -> bool:
    """Whether this rank writes a mesh's checkpoint: its first rank."""
    return all(c == 0 for c in mesh.get_coordinate())


def _barrier(mesh) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_group
    dist.barrier(group=mesh_group(mesh))

_MANIFEST = "manifest.json"


def leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    """``(name, leaf)`` in :func:`tree_leaves`' order, named as JAX's
    ``_leaf_paths`` names them: dict keys and list indices joined by
    ``_``, a ``NamedTuple`` field as ``.<field>`` (``opt_.m_...``)."""
    out: list[tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            fields = getattr(node, "_fields", None)
            for i, v in enumerate(node):
                walk(v, path + [f".{fields[i]}" if fields else str(i)])
        else:
            out.append(("_".join(path), node))
    walk(tree, [])
    return out


def _to_numpy(x: Any) -> np.ndarray:
    """A leaf as the array that is written: bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x: Any, arr: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The stored array as a tensor of the manifest's ``dtype``."""
    if dtype == "bfloat16":
        # uint16 bits (this package), |V2 or ml_dtypes' bfloat16 (JAX's)
        bits = np.asarray(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the committed directory.  A tree
    of ``DTensor`` leaves is gathered on every rank of its mesh, written
    by the first, and the call returns on every rank once it is
    committed."""
    leaves = tree_leaves(tree)
    mesh = _mesh_of(leaves)
    if mesh is None:
        return _write(ckpt_dir, step, tree)
    whole = tree_unflatten(tree, _gathered(leaves))
    if _is_writer(mesh):
        _write(ckpt_dir, step, whole)
    _barrier(mesh)
    return os.path.join(ckpt_dir, f"step_{step}")


def _write(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: dict[str, Any] = {"step": step, "leaves": {}}
    for name, leaf in leaf_paths(tree):
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"{name}.npy"), arr)
        manifest["leaves"][name] = {"shape": list(arr.shape),
                                    "dtype": _dtype_name(leaf, arr)}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _host_copy(x: Any) -> Any:
    """``x`` on the host, never sharing storage with ``x``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write in a background
    thread; one outstanding save at a time.  A mesh's tree is gathered
    before the snapshot, its first rank writes, and every rank's
    :meth:`wait` returns once that write is committed."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._mesh = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _barrier(mesh)

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        leaves = tree_leaves(tree)
        self._mesh = mesh = _mesh_of(leaves)
        if mesh is not None:
            leaves = _gathered(leaves)
            if not _is_writer(mesh):
                return
        host_tree = tree_unflatten(tree, [_host_copy(x) for x in leaves])

        def _commit():
            _write(self.ckpt_dir, step, host_tree)
            garbage_collect(self.ckpt_dir, self.keep)

        self._thread = threading.Thread(target=_commit, daemon=True)
        self._thread.start()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target: Any, device=None,
            shardings: Any | None = None) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors; on
    the ``meta`` device for shapes only, as JAX takes
    ``ShapeDtypeStruct``s): each leaf on its target leaf's device (the
    CPU for a meta leaf), or on ``device``; a leaf the checkpoint lacks
    raises ``ValueError``.  ``shardings`` (a tree like ``target`` of
    ``launch.sharding.NamedSharding``) reshards on load: each leaf a
    ``DTensor`` of that layout holding this rank's slice, on the rank's
    device of its mesh."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    named = leaf_paths(target)
    missing = [n for n, _ in named if n not in manifest["leaves"]]
    if missing:
        raise ValueError(
            f"checkpoint at step {step} missing leaves: {missing[:5]}")
    layouts = (tree_leaves(shardings) if shardings is not None
               else [None] * len(named))
    out = []
    for (name, leaf), sh in zip(named, layouts):
        arr = np.load(os.path.join(d, f"{name}.npy"))
        x = _from_numpy(arr, manifest["leaves"][name]["dtype"])
        if sh is not None:
            from repro_torch.launch.sharding import mesh_device
            part = ops.local_slice(x, sh.mesh, sh.placements)
            out.append(ops.wrap_local(part.to(mesh_device(sh.mesh)),
                                      sh.mesh, sh.placements, x.shape))
            continue
        dev = device if device is not None else getattr(leaf, "device",
                                                        "cpu")
        if torch.device(dev).type == "meta":   # a target of shapes only
            dev = "cpu"
        out.append(x.to(dev))
    return tree_unflatten(target, out)


def garbage_collect(ckpt_dir: str, keep: int) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_")
        and os.path.exists(os.path.join(ckpt_dir, n, _MANIFEST)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
