"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``src/repro/launch/train.py``).

Runs the fault-tolerant loop (:class:`repro_torch.train.Trainer`) on one
device: the CUDA card, or the CPU with ``--device cpu``.  It resumes from
the newest checkpoint under ``--ckpt-dir/<config name>``: run it again
with a larger ``--steps`` and it continues where it stopped.  A data or
model mesh axis above 1 needs the sharded executor (ROADMAP Queue 1 item
3) and raises.  The model is built with ``use_kernels=False`` (a
hand-written kernel has no backward; the port's default is the kernels)
and ``remat=True``, as JAX's launcher builds it.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticLMStream, make_global_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer


def main(argv: list[str] | None = None) -> list[dict[str, float]]:
    """Parse ``argv`` (default ``sys.argv``), train, print the history;
    returns it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: a training mesh needs "
            "the sharded executor (ROADMAP Queue 1 item 3), not ported yet; "
            "use one device (--data 1 --model 1)")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    stream = SyntheticLMStream(cfg, shape, DataConfig())
    opt_cfg = AdamWConfig(
        base_lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps)
    model = build_model(cfg, device=dev, use_kernels=False, remat=True)
    trainer = Trainer(
        model, opt_cfg, ckpt_dir=os.path.join(args.ckpt_dir, cfg.name),
        ckpt_every=args.ckpt_every, accum_steps=args.accum_steps,
        heartbeat=lambda step, dt: (
            print(f"  step {step}: {dt*1e3:.0f} ms") if step % 20 == 0
            else None))
    params, opt_state, start = trainer.init_or_restore(0)
    if start:
        print(f"resumed from step {start}")
    params, opt_state, hist = trainer.run(
        params, opt_state,
        lambda step: make_global_batch(stream.batch(step), dev),
        start, args.steps)
    for h in hist:
        print({k: round(v, 4) for k, v in h.items()})
    if hist:
        print(f"final loss: {hist[-1]['loss']:.4f}")
    else:
        print(f"no step to run: the checkpoint is at step {start}, "
              f"--steps {args.steps}")
    return hist


if __name__ == "__main__":
    main()
