"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``src/repro/launch/train.py``).

Runs the fault-tolerant loop (:class:`repro_torch.train.Trainer`) on one
device, the CUDA card or the CPU with ``--device cpu``, or SPMD on a
('data', 'model') mesh with ``--data D --model M`` (D x M > 1): every
rank runs this launcher with the same arguments, with the parameters
and AdamW moments laid out by ``launch.sharding`` and each rank fed its
rows of the batch.  With no process group started the launcher starts
one, ``init_process_group("gloo", init_method=--dist-init)``, with the
rank and world size of ``RANK`` / ``WORLD_SIZE``: ``torchrun --standalone
--nproc-per-node N -m repro_torch.launch.train --data D --model M ...``
sets them and the default ``env://`` rendezvous; ``--dist-init
file:///path`` needs no TCP port.  Only rank 0 prints; a rank the mesh
leaves out says so and returns.

It resumes from the newest checkpoint under ``--ckpt-dir/<config name>``:
run it again with a larger ``--steps`` and it continues where it
stopped.  The model is built with ``use_kernels=False`` (a hand-written
kernel has no backward; the port's default is the kernels) and
``remat=True``, and on a mesh with the shard hook, as JAX's launcher
builds it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import tempfile

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import (DataConfig, SyntheticLMStream, host_index_count,
                              make_global_batch)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer


def main(argv: list[str] | None = None) -> list[dict[str, float]]:
    """Parse ``argv`` (default ``sys.argv``), train, print the history;
    returns it (empty on a rank the mesh leaves out)."""
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
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's rendezvous on a mesh "
                         "(init_method of init_process_group): env:// "
                         "under torchrun, or file:///path")
    args = ap.parse_args(argv)
    if args.data * args.model == 1:
        return train(args, resolve_device(args.device), None)

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, rank_device, start_group
    started = start_group(args.dist_init,
                          f"--data {args.data} --model {args.model}",
                          "repro_torch.launch.train --data D --model M")
    try:
        dev = rank_device(args.device)
        mesh = make_host_mesh(args.data, args.model, device=dev)
        if mesh.get_coordinate() is None:
            print(f"rank {dist.get_rank()}: idle, the {mesh.size()}-rank "
                  f"training mesh leaves this rank out")
            return []
        # every rank trains; rank 0 alone prints
        quiet = (contextlib.redirect_stdout(io.StringIO())
                 if dist.get_rank() else contextlib.nullcontext())
        with quiet:
            return train(args, dev, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def train(args, dev, mesh) -> list[dict[str, float]]:
    """The run on ``dev``, on ``mesh`` where one is given."""
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    opt_cfg = AdamWConfig(
        base_lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps)
    kw = {}
    if mesh is not None:
        from repro_torch.launch.sharding import make_shard_hook
        kw["shard"] = make_shard_hook(mesh)
        # on a mesh the stream's process is the host; ranks take its rows
        stream = SyntheticLMStream(cfg, shape, DataConfig(),
                                   process=host_index_count())
    else:
        stream = SyntheticLMStream(cfg, shape, DataConfig())
    model = build_model(cfg, device=dev, use_kernels=False, remat=True, **kw)
    trainer = Trainer(
        model, opt_cfg, ckpt_dir=os.path.join(args.ckpt_dir, cfg.name),
        ckpt_every=args.ckpt_every, accum_steps=args.accum_steps,
        heartbeat=lambda step, dt: (
            print(f"  step {step}: {dt*1e3:.0f} ms") if step % 20 == 0
            else None),
        mesh=mesh)
    params, opt_state, start = trainer.init_or_restore(0)
    if start:
        print(f"resumed from step {start}")
    params, opt_state, hist = trainer.run(
        params, opt_state,
        lambda step: make_global_batch(stream.batch(step), mesh or dev),
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
