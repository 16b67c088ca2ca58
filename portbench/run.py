#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a device trace of a
slice of the window.  Either way the run checks what the timed path
produced against the plain reference (``correct``) and prints each
number compared beside its limit, last on standard error and last in the
result line.  Without a CUDA card, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result."""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: top-level module names that may not be loaded when the result prints:
#: JAX and the JAX package (``repro``; the port is ``repro_torch``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Ctx:
    """What a cell's loop needs to run the cell once."""

    def __init__(self, **kw):
        self.frames = None              # pool frames (None: sized by rule)
        self.kv_dtype = "native"
        self.fp8_control = False
        self.limits = None              # None: limits/<cell>.json
        self.__dict__.update(kw)


def caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def card_line() -> str:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return p.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def context(args, device) -> Ctx:
    from portbench.lib import spec
    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    conf = spec.config(bench, cell["config"], ROOT)
    return Ctx(seed=args.seed, seconds=float(args.seconds),
               trace=bool(args.trace), bench=bench, cell=cell, conf=conf,
               dims=spec.dims(conf), mix=spec.mix(cell["traffic"]),
               device=device)


def result(ctx, out: dict, t_proc: float) -> dict:
    """The result line's object."""
    from portbench.lib import spec
    import torch
    metrics = {}
    if ctx.trace:
        rec = out["record"]
        for m in spec.metrics_of(ctx.bench, ctx.cell["name"], True):
            v = spec.module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        e2e = dict(out["e2e"], setup_s=out["t_window_open"] - t_proc)
        for m in spec.metrics_of(ctx.bench, ctx.cell["name"], False):
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=ctx.cell["chips"],
                  memory_peak_bytes=out["memory_peak"])
    res = dict(correct=out["check"]["correct"], attempted=out["attempted"],
               failed=out["failed"], metrics=metrics, device=device)
    tr = out["record"].get("trace")
    if tr is not None:
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        res["breakdown"] = dict(
            device_ops=tr.device_ops(),
            idle_gaps=tr.idle_gaps(out["record"]["trace_spans"]))
    res["check"] = out["check"]["numbers"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    from portbench.lib import check, spec
    import torch
    ctx = context(args, torch.device("cuda"))
    need = ctx.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    # the traffic kind's module drives the cell
    out = spec.module("traffic", ctx.mix["kind"]).run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    res = result(ctx, out, T_PROC)
    for k, v in out.get("notes", {}).items():
        print(f"note {k}: {v!r}", file=sys.stderr)
    print(f"note pool: {out.get('pool')!r}", file=sys.stderr)
    print(f"note readings: {out['check']['readings']!r}", file=sys.stderr)
    check.report(res["check"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
