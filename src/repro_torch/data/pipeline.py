"""Deterministic synthetic data pipeline (port of
``src/repro/data/pipeline.py``).

A seeded, reproducible token stream (a Zipf-ish marginal over the vocab,
so losses move like language data), document packing with loss masks and
per-process slicing.  Batches are keyed by ``(seed, step, process)``:
resuming at step K yields the same batch K every time, which the
checkpoint/restart path relies on.

The synthesis is numpy, with JAX's generator and JAX's calls in JAX's
order (``rng.choice`` of the tokens, ``rng.integers`` of the document
boundaries, ``rng.normal`` of the VLM's vision prefix), so a batch equals
the JAX package's bit for bit.  The process index and count come from
``torch.distributed`` when it is initialised (JAX: ``jax.process_index()``
and ``jax.process_count()``), else 0 and 1.  On a mesh a JAX process is a
host, not a rank: the launcher keys the stream by
:func:`host_index_count` (``process=``), so every rank of a host
synthesizes the same host batch, and :func:`make_global_batch` hands each
rank its rows of it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, ShapeConfig


def _process_index_count() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_index_count() -> tuple[int, int]:
    """This process's host and the number of hosts of a ``torchrun`` job:
    its node rank (``GROUP_RANK``) and ``WORLD_SIZE // LOCAL_WORLD_SIZE``;
    (0, 1) where those are not set (every rank on one host)."""
    env = os.environ
    if "GROUP_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        return (int(env["GROUP_RANK"]),
                int(env["WORLD_SIZE"]) // int(env["LOCAL_WORLD_SIZE"]))
    return 0, 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    mean_doc_len: int = 512      # document packing geometry
    pad_id: int = 0


class SyntheticLMStream:
    """Deterministic packed-LM batches: tokens/labels/mask (+ modality
    extras), as numpy arrays."""

    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig(), *,
                 process: tuple[int, int] | None = None):
        self.model_cfg = model_cfg
        self.shape = shape
        self.data_cfg = data_cfg
        #: ``(index, count)`` of the process the stream is keyed by and
        #: sliced for; None: ``torch.distributed``'s rank and world size
        self.process = process
        ranks = np.arange(1, model_cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    # ---- host sharding ------------------------------------------------

    def _process(self) -> tuple[int, int]:
        return self.process or _process_index_count()

    def host_batch_size(self) -> int:
        n = self._process()[1]
        b = self.shape.global_batch
        assert b % n == 0, f"global batch {b} not divisible by {n} hosts"
        return b // n

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.data_cfg.seed, step, self._process()[0]))

    # ---- batch synthesis ----------------------------------------------

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg, shape = self.model_cfg, self.shape
        b, s = self.host_batch_size(), shape.seq_len
        rng = self._rng(step)
        if cfg.family == "audio" and cfg.num_codebooks > 1:
            toks = rng.choice(
                cfg.vocab_size, size=(b, s + 1, cfg.num_codebooks),
                p=self._probs).astype(np.int32)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": self._doc_mask(rng, b, s)}
        toks = rng.choice(cfg.vocab_size, size=(b, s + 1),
                          p=self._probs).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "mask": self._doc_mask(rng, b, s)}
        if cfg.family == "vlm":
            n_vis = min(256, s // 4)
            out["vision_embeds"] = rng.normal(
                size=(b, n_vis, cfg.d_model)).astype(np.float32) * 0.02
            # M-RoPE positions: the vision prefix on a 2-D grid, text linear
            pos = np.broadcast_to(np.arange(s), (b, s)).copy()
            grid = max(int(np.sqrt(n_vis)), 1)
            t_pos, h_pos, w_pos = pos.copy(), pos.copy(), pos.copy()
            h_pos[:, :n_vis] = np.arange(n_vis) // grid
            w_pos[:, :n_vis] = np.arange(n_vis) % grid
            t_pos[:, :n_vis] = 0
            out["positions"] = np.stack([t_pos, h_pos, w_pos]).astype(
                np.int32)
        return out

    def _doc_mask(self, rng: np.random.Generator, b: int, s: int
                  ) -> np.ndarray:
        """Document-packing loss mask: 0 at (simulated) document
        boundaries."""
        mask = np.ones((b, s), np.float32)
        n_bounds = max(1, s // self.data_cfg.mean_doc_len)
        bounds = rng.integers(0, s, size=(b, n_bounds))
        rows = np.repeat(np.arange(b), n_bounds)
        mask[rows, bounds.reshape(-1)] = 0.0
        return mask

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_global_batch(host_batch: dict[str, np.ndarray], device=None,
                      batch_spec: tuple | None = None
                      ) -> dict[str, torch.Tensor]:
    """The host batch as tensors on ``device`` (``None``: the card); or,
    where ``device`` is a ``DeviceMesh``, as ``DTensor``s of the global
    batch split along the batch axis by ``batch_spec`` (JAX's ``P(dp)``;
    default: the mesh's data-parallel axes), dim 1 of the ``[3, B, S]``
    positions: each rank holds its rows, on its device.

    The global batch is the hosts' batches in host order
    (:func:`host_index_count`); a rank's rows must lie in its host's
    batch."""
    if hasattr(device, "mesh_dim_names"):
        return _mesh_batch(host_batch, device, batch_spec)
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in host_batch.items()}


def _mesh_batch(host_batch, mesh, batch_spec) -> dict[str, Any]:
    from torch.distributed.tensor import Shard
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    if batch_spec is None:
        batch_spec = (sharding.dp_spec(mesh),)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("make_global_batch: this rank is not in the mesh")
    host, hosts = host_index_count()
    dev = sharding.mesh_device(mesh)
    out = {}
    for name, x in host_batch.items():
        x = np.asarray(x)
        if name == "positions" and x.ndim == 3:    # [3, B, S]: batch dim 1
            spec, dim = (None, *batch_spec), 1
        else:
            spec, dim = (*batch_spec, *([None] * (x.ndim - 1))), 0
        layout = sharding.spec_placements(mesh, spec)
        shape = list(x.shape)
        shape[dim] *= hosts
        lo, size = 0, shape[dim]
        for i, p in enumerate(layout):
            if isinstance(p, Shard):
                if size % mesh.size(i):
                    raise ValueError(f"{name}: dim {dim} of {tuple(shape)} "
                                     f"does not split over {mesh.size(i)}")
                size //= mesh.size(i)
                lo += coord[i] * size
        lo -= host * x.shape[dim]
        if lo < 0 or lo + size > x.shape[dim]:
            raise ValueError(f"{name}: this rank's rows are not in host "
                             f"{host}'s batch")
        rows = np.ascontiguousarray(np.take(x, range(lo, lo + size),
                                            axis=dim))
        out[name] = ops.wrap_local(torch.from_numpy(rows).to(dev), mesh,
                                   layout, shape)
    return out
