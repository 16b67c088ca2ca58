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
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import PerfCounters
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               tree_leaves, tree_map, tree_unflatten)


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
    ``grad_shardings`` needs a mesh (the sharded executor) and raises."""
    del donate
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings constrains gradients to a mesh layout; the "
            "sharded executor (ROADMAP Queue 1 item 3) is not ported")

    def single(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, params, batch)
        params, opt_state, opt_m = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {**metrics, **opt_m, "loss": loss}

    def accumulated(params, opt_state, batch):
        _check_splittable(batch, accum_steps)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for i in range(accum_steps):
            li, _, gi = value_and_grad(model, params,
                                       _micro(batch, accum_steps, i))
            grads = tree_map(lambda a, g: a + g.float() / accum_steps,
                             grads, gi)
            loss = loss + li / accum_steps
            del gi
        params, opt_state, opt_m = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, {**opt_m, "loss": loss}

    return single if accum_steps == 1 else accumulated


class Trainer:
    """Auto-resuming training loop with preemption-safe checkpointing."""

    def __init__(self, model: Any, opt_cfg: AdamWConfig, *, ckpt_dir: str,
                 ckpt_every: int = 50, keep: int = 3, accum_steps: int = 1,
                 heartbeat: Callable[[int, float], None] | None = None):
        self.model = model
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
        checkpoint."""
        params = self.model.init(seed)
        opt_state = adamw_init(params, self.opt_cfg.moment_dtype)
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is None:
            return params, opt_state, 0
        restored = ckpt.restore(self.ckpt_dir, latest,
                                {"params": params, "opt": opt_state})
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
