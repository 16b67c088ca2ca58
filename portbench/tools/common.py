"""Shared by the tools: ``run.py`` loaded as a module and a cell's
context built from its name."""

from __future__ import annotations

import importlib.util
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def runner():
    spec = importlib.util.spec_from_file_location(
        "portbench_run", ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def context(workload: str, seed: int, seconds: float, **kw):
    import torch
    run = runner()
    run.caches()
    args = types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=0)
    ctx = run.context(args, torch.device("cuda"))
    ctx.__dict__.update(kw)
    return ctx
