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
and ``jax.process_count()``), else 0 and 1.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, ShapeConfig


def _process_index_count() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
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
                 data_cfg: DataConfig = DataConfig()):
        self.model_cfg = model_cfg
        self.shape = shape
        self.data_cfg = data_cfg
        ranks = np.arange(1, model_cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    # ---- host sharding ------------------------------------------------

    def host_batch_size(self) -> int:
        n = _process_index_count()[1]
        b = self.shape.global_batch
        assert b % n == 0, f"global batch {b} not divisible by {n} hosts"
        return b // n

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.data_cfg.seed, step, _process_index_count()[0]))

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


def make_global_batch(host_batch: dict[str, np.ndarray], device=None
                      ) -> dict[str, torch.Tensor]:
    """The host batch as tensors on ``device`` (``None``: the card) — the
    single-card form of JAX's ``make_global_batch``; the mesh form, which
    shards the batch axis (dim 1 of ``[3, B, S]`` positions), comes with
    the sharded executor."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in host_batch.items()}
