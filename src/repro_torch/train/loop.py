"""Fault-tolerant training: the step factory and the auto-resuming loop
(port of ``src/repro/train/loop.py``).

  * :func:`make_train_step` builds ``(params, opt_state, batch) ->
    (params, opt_state, metrics)``, with optional microbatch gradient
    accumulation in f32 (activation memory bounded by one microbatch);
  * :class:`Trainer` resumes from the newest atomic checkpoint, saves
    async every ``ckpt_every`` steps, takes an emergency checkpoint on
    SIGTERM / ``KeyboardInterrupt`` (preemption) and re-raises; a
    restarted job continues bit-identically, since the data stream is
    keyed by step;
  * the heartbeat hook is called every step with ``(step, seconds)``
    (:class:`repro_torch.train.StragglerMonitor` consumes it).

The step is eager PyTorch: autograd through the model's plain versions
(a hand-written kernel has no backward; train a model built with
``use_kernels=False``, as JAX's trainer does) and the functional AdamW of
``repro_torch.optim``.

On a ('data', 'model') mesh the parameters and both AdamW moments are
``DTensor``s in ``launch.sharding``'s layouts (each rank holds JAX's
shard: ZeRO-3 memory) and the batch is split over the data-parallel axes
(``data.make_global_batch``).  The layouts are carried by the DTensors;
the compute runs on plain tensors.  A step:

  1. gathers each parameter whole, one all-gather a split leaf
     (``ops.whole``; a replicated leaf is used as it is);
  2. runs :func:`value_and_grad` on this rank's rows, the loss's batch
     statistics summed over the data-parallel ranks
     (``layers.data_parallel``), so the loss is the whole batch's and the
     gradient this rank's rows' share of it;
  3. reduces each gradient onto its parameter's layout
     (``grad_shardings``): a sum over the data-parallel ranks, then this
     rank's slice;
  4. runs AdamW on the local slices, the clipping norm summed over the
     mesh.

The ranks along ``model`` repeat the same forward and backward on the
same rows, where JAX's GSPMD splits them (a divergence of form: the
layouts and the results are JAX's).
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import PerfCounters
from repro_torch.data import make_global_batch
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               tree_leaves, tree_map, tree_unflatten)
from repro_torch.optim.adamw import like


def value_and_grad(model: Any, params: Any, batch: dict[str, Any]):
    """``(loss, metrics, grads)`` of ``model.loss(params, batch)``: the
    loss and metrics detached, the gradients a tree like ``params``.  The
    parameters require grad only inside this call."""
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _micro(batch: dict[str, Any], accum_steps: int, i: int) -> dict:
    """Microbatch ``i`` of ``accum_steps``: every leaf of ndim >= 1
    reshaped to ``(accum, B / accum, ...)`` and indexed, as JAX's."""
    def split(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        return x.reshape((accum_steps, x.shape[0] // accum_steps)
                         + tuple(x.shape[1:]))[i]
    return {k: split(v) for k, v in batch.items()}


def _check_splittable(batch: dict[str, Any], accum_steps: int) -> None:
    pos = batch.get("positions")
    if pos is not None and pos.ndim == 3:
        raise ValueError(
            "gradient accumulation splits every batch leaf along its first "
            f"axis; the M-RoPE positions {tuple(pos.shape)} are [3, B, S], "
            "batch on axis 1 (the JAX package's step fails on them too)")
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.ndim and (
                v.shape[0] % accum_steps):
            raise ValueError(f"batch leaf {k!r} {tuple(v.shape)}: leading "
                             f"dim not a multiple of accum_steps "
                             f"{accum_steps}")


def _dp_groups(mesh) -> list:
    """The process groups of the mesh's data-parallel axes that split the
    batch (extent above 1)."""
    from repro_torch.launch.mesh import dp_axes
    return [mesh.get_group(a) for a in dp_axes(mesh)
            if mesh.size(mesh.mesh_dim_names.index(a)) > 1]


def _element_bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def make_train_step(model: Any, opt_cfg: AdamWConfig, *,
                    accum_steps: int = 1, donate: bool = True,
                    grad_shardings: Any | None = None) -> Callable:
    """The train step.  With ``accum_steps > 1`` the batch's leading dim
    is split into microbatches, the gradients summed in f32 as ``acc +
    g / accum_steps`` from zeros and the loss as ``loss / accum_steps``
    (JAX's order) before one optimizer update; that step's metrics are
    ``{**opt_m, "loss"}`` only, as JAX's.

    ``donate`` is kept for JAX's signature: the step returns new trees
    and changes none it is given, so a caller that rebinds its names
    (``params, opt = step(params, opt, batch)``) frees the old trees.

    Given ``DTensor`` parameters (a mesh), the step is the mesh step of
    this module's docstring: ``grad_shardings``, a tree of
    ``launch.sharding.NamedSharding`` like the parameters (JAX's: the
    parameter shardings), is the layout each gradient is reduced onto
    (default: its parameter's; another raises), and the batch is the mesh
    ``make_global_batch``'s.  Microbatch ``i`` is the global rows ``[i B /
    a, (i + 1) B / a)``, JAX's, of which each rank takes its data shard.
    ``step.comm`` holds the bytes the last mesh step received in its
    all-gathers and sent into its all-reduces."""
    del donate
    comm = {"gathered": 0, "reduced": 0}

    def single(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, params, batch)
        params, opt_state, opt_m = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {**metrics, **opt_m, "loss": loss}

    def accumulate(params, micro_batches):
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for i in range(accum_steps):
            li, _, gi = value_and_grad(model, params, micro_batches(i))
            grads = tree_map(lambda a, g: a + g.float() / accum_steps,
                             grads, gi)
            loss = loss + li / accum_steps
            del gi
        return loss, grads

    def accumulated(params, opt_state, batch):
        _check_splittable(batch, accum_steps)
        loss, grads = accumulate(
            params, lambda i: _micro(batch, accum_steps, i))
        params, opt_state, opt_m = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {**opt_m, "loss": loss}

    def on_mesh(params, opt_state, batch):
        from torch.distributed.tensor import Shard
        leaves = tree_leaves(params)
        mesh = leaves[0].device_mesh
        layouts = [x.placements for x in leaves]
        if grad_shardings is not None:
            want = [s.placements for s in tree_leaves(grad_shardings)]
            if want != layouts:
                raise ValueError(
                    "grad_shardings differ from the parameters' layouts; "
                    "the mesh step reduces each gradient onto its "
                    "parameter's slice")
        for k, x in batch.items():
            if not ops.is_dtensor(x):
                raise TypeError(f"batch leaf {k!r}: the mesh step takes the "
                                "mesh make_global_batch's DTensors")
        whole = tree_unflatten(params, [ops.whole(x) for x in leaves])
        comm["gathered"] = sum(
            (mesh.size() - 1) * _element_bytes(x.to_local())
            for x in leaves if any(isinstance(p, Shard)
                                   for p in x.placements))
        groups = _dp_groups(mesh)
        with L.data_parallel(groups):
            if accum_steps == 1:
                loss, metrics, grads = value_and_grad(
                    model, whole, {k: x.to_local() for k, x in batch.items()})
            else:
                full = {k: ops.whole(x) for k, x in batch.items()}
                _check_splittable(full, accum_steps)
                loss, grads = accumulate(whole, lambda i: {
                    k: ops.local_slice(v, mesh, batch[k].placements)
                    for k, v in _micro(full, accum_steps, i).items()})
        del whole
        comm["reduced"] = 0
        sliced = []
        for g, p in zip(tree_leaves(grads), leaves):
            for group in groups:
                torch.distributed.all_reduce(g, group=group)
                comm["reduced"] += _element_bytes(g)
            sliced.append(like(p, ops.local_slice(g, mesh, p.placements)))
        del grads
        params, opt_state, opt_m = adamw_update(
            tree_unflatten(params, sliced), opt_state, params, opt_cfg)
        if accum_steps == 1:
            return params, opt_state, {**metrics, **opt_m, "loss": loss}
        return params, opt_state, {**opt_m, "loss": loss}

    plain = single if accum_steps == 1 else accumulated

    def step(params, opt_state, batch):
        if ops.is_dtensor(tree_leaves(params)[0]):
            return on_mesh(params, opt_state, batch)
        if grad_shardings is not None:
            raise ValueError("grad_shardings lays gradients out on a mesh: "
                             "pass the parameters as DTensors "
                             "(launch.sharding.shard_tree)")
        return plain(params, opt_state, batch)

    step.comm = comm
    return step


class Trainer:
    """Auto-resuming training loop with preemption-safe checkpointing."""

    def __init__(self, model: Any, opt_cfg: AdamWConfig, *, ckpt_dir: str,
                 ckpt_every: int = 50, keep: int = 3, accum_steps: int = 1,
                 heartbeat: Callable[[int, float], None] | None = None,
                 mesh=None):
        """``mesh``: a ('data', 'model') ``DeviceMesh`` to train on (JAX's
        trainer takes the ambient mesh of ``use_mesh``): the parameters
        and moments are laid out by ``launch.sharding``, a resume restores
        onto those layouts, and :meth:`run` hands each rank its rows."""
        self.model = model
        self.mesh = mesh
        self.opt_cfg = opt_cfg
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.accum_steps = accum_steps
        self.heartbeat = heartbeat
        self.counters = PerfCounters()
        self.checkpointer = ckpt.AsyncCheckpointer(ckpt_dir, keep=keep)
        self.step_fn = make_train_step(model, opt_cfg,
                                       accum_steps=accum_steps)
        self._preempted = False

    # ------------------------------------------------------------------

    def init_or_restore(self, seed: int) -> tuple[Any, Any, int]:
        """Fresh init from ``seed``, or resume from the newest
        checkpoint; on a mesh, laid out by ``launch.sharding``."""
        params = self.model.init(seed)
        shardings = None
        if self.mesh is not None:
            from repro_torch.launch import sharding
            shardings = {"params": sharding.param_shardings(params,
                                                            self.mesh),
                         "opt": sharding.opt_shardings(params, self.mesh)}
            self.step_fn = make_train_step(
                self.model, self.opt_cfg, accum_steps=self.accum_steps,
                grad_shardings=shardings["params"])
            params = sharding.shard_tree(params, shardings["params"])
        opt_state = adamw_init(params, self.opt_cfg.moment_dtype)
        if shardings is not None:
            opt_state = opt_state._replace(step=sharding.shard_tree(
                opt_state.step, shardings["opt"].step))
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is None:
            return params, opt_state, 0
        restored = ckpt.restore(self.ckpt_dir, latest,
                                {"params": params, "opt": opt_state},
                                shardings=shardings)
        self.counters.snapshot("resumed", latest)
        return restored["params"], restored["opt"], latest

    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread

    # ------------------------------------------------------------------

    def run(self, params: Any, opt_state: Any,
            batches: Callable[[int], dict[str, Any]], start_step: int,
            num_steps: int, log_every: int = 10
            ) -> tuple[Any, Any, list[dict[str, float]]]:
        self._install_preemption_handler()
        history: list[dict[str, float]] = []
        step = start_step
        try:
            for step in range(start_step, num_steps):
                t0 = time.perf_counter()
                batch = batches(step)
                if self.mesh is not None and not all(
                        ops.is_dtensor(x) for x in batch.values()):
                    batch = make_global_batch(batch, self.mesh)
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                if step % log_every == 0 or step == num_steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    history.append(m)
                dt = time.perf_counter() - t0
                self.counters.inc("steps")
                if self.heartbeat:
                    self.heartbeat(step, dt)
                if (step + 1) % self.ckpt_every == 0:
                    self.checkpointer.save_async(
                        step + 1, {"params": params, "opt": opt_state})
                if self._preempted:
                    raise KeyboardInterrupt("preemption signal")
        except (KeyboardInterrupt, SystemExit):
            # emergency checkpoint, then surface the preemption
            self.checkpointer.wait()
            ckpt.save(self.ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state})
            self.counters.snapshot("preempt_checkpoint", step + 1)
            raise
        self.checkpointer.wait()
        ckpt.save(self.ckpt_dir, num_steps,
                  {"params": params, "opt": opt_state})
        return params, opt_state, history
