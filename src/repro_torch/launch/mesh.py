"""Production and serve meshes on ``torch.distributed``'s ``DeviceMesh``.

Port of ``src/repro/launch/mesh.py``.  Each factorization is a plain
function of ints (``*_mesh_shape``), so it can be held to the JAX
package's at 256 or 512 devices without that many ranks; the ``make_*``
functions build a ``DeviceMesh`` of that shape over ranks ``0 .. n - 1``
of the caller's default process group.

* "Visible devices" is the process group's world size.  Ranks past the
  mesh's size are left out of it, as JAX leaves devices out; every rank of
  the group still calls ``make_*`` (creating the mesh's sub-groups is a
  collective of the whole group), and a rank left out gets a mesh whose
  ``get_coordinate()`` is ``None``.
* The device type is :func:`repro_torch.device.resolve_device`'s: ``cuda``
  unless the caller passes ``device="cpu"``.  Several ranks may share one
  card; their collectives then need a backend that allows it (``gloo``).
* With no initialized process group the ``make_*`` functions raise: the
  caller starts the group (``torch.distributed.init_process_group`` with
  its own rendezvous, rank and world size); no 1 x 1 mesh is made on its
  own.
* :func:`mesh_group` is the process group of exactly a mesh's ranks, for
  a collective over the whole mesh at once (the executor's spill gathers
  a victim's pages from every rank in one ``all_gather``): the default
  group where the mesh spans the world, else a group the ``make_*`` call
  created beside the mesh, collectively, as it creates the mesh's own.

JAX's ``compat_make_mesh`` and ``use_mesh`` have no counterpart: they
paper over JAX versions (``axis_types``, ``jax.set_mesh``), and a
``DeviceMesh`` is passed explicitly, never set as an ambient context.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: the names of the serve mesh's (kv, hd) tile of the model axis
SERVE_AXES = ("kv", "hd")


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """16 x 16 (one pod, 256 devices) or 2 x 16 x 16 (two pods)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def serve_mesh_shape(num_kv_heads: int, head_dim: int, *,
                     multi_pod: bool = False, model_size: int = 16
                     ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production topology with its model axis viewed as a (kv, hd)
    tile: kv is the first of 16, 8, 4, 2, 1 that fits ``model_size`` and
    divides ``num_kv_heads``; hd = model_size // kv.  Where hd does not
    divide ``head_dim`` the tile degrades to (1, model_size), and raises
    ``ValueError`` if that does not divide it either."""
    kv = 1
    for cand in (16, 8, 4, 2, 1):
        if cand <= model_size and num_kv_heads % cand == 0:
            kv = cand
            break
    hd = model_size // kv
    if head_dim % hd != 0:
        kv, hd = 1, model_size
        if head_dim % hd != 0:
            raise ValueError(f"cannot factor model axis for "
                             f"Hkv={num_kv_heads}, head_dim={head_dim}")
    if multi_pod:
        return (2, 16, kv, hd), ("pod", "data") + SERVE_AXES
    return (16, kv, hd), ("data",) + SERVE_AXES


def host_serve_mesh_shape(num_kv_heads: int, head_dim: int,
                          num_devices: int) -> tuple[int, int]:
    """``(kv, hd)`` over at most ``num_devices``: the most devices such
    that kv divides ``num_kv_heads`` and hd divides ``head_dim``, ties to
    the larger kv (head-parallel attention needs no collective).  (1, 1)
    always factors."""
    if num_devices < 1:
        raise ValueError("need at least one device")
    for size in range(num_devices, 0, -1):
        for kv in range(min(size, num_kv_heads), 0, -1):
            if size % kv or num_kv_heads % kv:
                continue
            if head_dim % (size // kv) == 0:
                return kv, size // kv
    raise AssertionError("unreachable: (1, 1) always factors")


def partition_axes(extents: dict[str, int], num_kv_heads: int,
                   head_dim: int) -> tuple[str | None, str | None]:
    """:func:`kv_partition_axes` on a mapping of axis name to extent."""
    def ok(dim: int, ax: str) -> str | None:
        if ax not in extents or dim % extents[ax]:
            return None
        return ax

    return ok(num_kv_heads, "kv"), ok(head_dim, "hd")


def mesh_extents(mesh) -> dict[str, int]:
    """``{axis name: extent}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def kv_partition_axes(mesh, num_kv_heads: int, head_dim: int
                      ) -> tuple[str | None, str | None]:
    """Mesh axes ``(kv_axis, hd_axis)`` of KV-shaped operands: an axis is
    used only when the mesh has it AND its extent divides the dim;
    otherwise that dim degrades to replicated (``None``).  The one source
    of how (Hkv, head_dim) map onto a (kv, hd) mesh: the sharded wrappers
    of ``kernels.ops`` and ``TransformerLM.init_kv_state`` both read it."""
    return partition_axes(mesh_extents(mesh), num_kv_heads, head_dim)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: ('pod', 'data') or ('data',)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def fsdp_axis(mesh) -> str | None:
    """The parameter-sharding (FSDP) axis: 'data' only, never across
    pods."""
    return "data" if "data" in mesh.mesh_dim_names else None


def _world_size() -> int:
    """The default process group's size; raises when none is started."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group("
            "backend, init_method=..., rank=..., world_size=...) on every "
            "rank before building a mesh")
    return dist.get_world_size()


#: the process group of ranks ``0 .. n - 1``, keyed by (the world's group,
#: n) for each ``n`` smaller than the world a mesh was made over
#: (:func:`mesh_group`)
_GROUPS: dict[tuple, object] = {}


def _mk(shape: tuple[int, ...], axes: tuple[str, ...], device):
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = _world_size()
    if n > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has {world}")
    key = (dist.group.WORLD, n)
    if n < world and key not in _GROUPS:
        # a collective of the whole group, like the mesh's own sub-groups
        _GROUPS[key] = dist.new_group(list(range(n)))
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def mesh_group(mesh):
    """The process group of exactly ``mesh``'s ranks (``0 .. size - 1``):
    ``None`` (the default group) where the mesh spans the world."""
    n = mesh.size()
    return (None if n == dist.get_world_size()
            else _GROUPS[(dist.group.WORLD, n)])


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 ('data', 'model') or 2 x 16 x 16 ('pod', 'data', 'model')."""
    return _mk(*production_mesh_shape(multi_pod=multi_pod), device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A small ('data', 'model') mesh (tests, examples)."""
    return _mk((data, model), ("data", "model"), device)


def make_serve_mesh(num_kv_heads: int, head_dim: int, *,
                    multi_pod: bool = False, model_size: int = 16,
                    device=None):
    """The serve mesh of :func:`serve_mesh_shape`."""
    return _mk(*serve_mesh_shape(num_kv_heads, head_dim, multi_pod=multi_pod,
                                 model_size=model_size), device)


def make_host_serve_mesh(num_kv_heads: int, head_dim: int,
                         num_devices: int | None = None, *, device=None):
    """A ('kv', 'hd') mesh over the process group's ranks, shaped by
    :func:`host_serve_mesh_shape`; ``num_devices`` caps the search
    (clamped to the world size)."""
    world = _world_size()
    n = min(num_devices, world) if num_devices is not None else world
    return _mk(host_serve_mesh_shape(num_kv_heads, head_dim, n), SERVE_AXES,
               device)


def start_group(init_method: str, what: str, command: str) -> bool:
    """Start the gloo process group a mesh launcher needs, with the rank
    and world size of ``RANK`` / ``WORLD_SIZE`` and ``init_method`` (the
    launcher's ``--dist-init``), unless one is started already; True when
    this call started it.  Without ``RANK`` / ``WORLD_SIZE`` it exits
    with a message that names ``what`` asked for a mesh and how to run
    ``command`` under torchrun."""
    if dist.is_initialized():
        return False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            f"{what}: every rank needs RANK and WORLD_SIZE to join the "
            f"process group; run it under torchrun (torchrun --standalone "
            f"--nproc-per-node N -m {command} ...), or set them and pass "
            "--dist-init file:///path/to/store")
    dist.init_process_group("gloo", init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def rank_device(device=None):
    """A mesh rank's device: the CPU if ``device`` asks for it, else the
    card ``LOCAL_RANK`` (or ``RANK``) names, modulo the cards there are,
    made the current device."""
    if device is not None and torch.device(device).type == "cpu":
        return device
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev
