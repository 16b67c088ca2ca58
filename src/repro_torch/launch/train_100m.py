"""End to end: train a ~100M-parameter dense LM for a few hundred
steps (port of ``examples/train_100m.py``).

Exercises the whole training substrate of the port — the synthetic packed
data stream, AdamW with its cosine schedule and clipping, gradient
accumulation, activation checkpointing, the async atomic checkpointer and
auto-resume — and checks that the loss drops well below its first value.

Run on the card:  ``PYTHONPATH=src python -m repro_torch.launch.train_100m
[--steps 300]`` (``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.data import DataConfig, SyntheticLMStream, make_global_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer

# ~100M params: 12 layers, d=512, vocab 32k
CFG = ModelConfig(
    name="lm-100m", family="dense", num_layers=12, d_model=512,
    num_heads=8, num_kv_heads=4, d_ff=2048, vocab_size=32_000,
    head_dim=64, param_dtype="float32",
)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def main(argv: list[str] | None = None) -> dict:
    """Train, print the history and the loss drop; returns ``{"history",
    "seconds", "tokens", "checkpoints": [(step, bytes)]}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--accum-steps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = build_model(CFG, device=dev, use_kernels=False, remat=True)
    print(f"params: {CFG.param_count()/1e6:.0f}M")
    shape = ShapeConfig("ex", args.seq_len, args.global_batch, "train")
    stream = SyntheticLMStream(CFG, shape, DataConfig(seed=7))
    opt = AdamWConfig(base_lr=1e-3, warmup_steps=20, total_steps=args.steps)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(model, opt, ckpt_dir=ckpt_dir, ckpt_every=100,
                          accum_steps=args.accum_steps)
        params, opt_state, start = trainer.init_or_restore(0)
        t0 = time.perf_counter()
        params, opt_state, hist = trainer.run(
            params, opt_state,
            lambda s: make_global_batch(stream.batch(s), dev),
            start, args.steps, log_every=25)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        ckpts = sorted((int(n.split("_")[1]),
                        _dir_bytes(os.path.join(ckpt_dir, n)))
                       for n in os.listdir(ckpt_dir)
                       if n.startswith("step_"))
    tokens = args.steps * args.global_batch * args.seq_len
    print(f"\n{args.steps} steps / {tokens/1e6:.1f}M tokens in {dt:.0f}s")
    for h in hist:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"lr {h['lr']:.2e}  |g| {h['grad_norm']:.2f}")
    drop = hist[0]["loss"] - hist[-1]["loss"]
    print(f"loss drop: {drop:.3f} "
          f"({hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f})")
    assert drop > 0.5, "training failed to learn"
    return {"history": hist, "seconds": dt, "tokens": tokens,
            "checkpoints": ckpts}


if __name__ == "__main__":
    main()
