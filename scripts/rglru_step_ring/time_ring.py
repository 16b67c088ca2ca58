"""Times csrc/rglru.cu's step route against TMA-ring variants of it.

The step route streams the two bf16 gate weights with each thread's
16-byte loads 8 rows ahead in registers.  ``ring.cu`` (thread 0 refills a
ring of 2-D TMA tiles) and ``ring_ws.cu`` (a producer warp refills it,
with and without L2 promotion) stream them through shared memory
instead.  Each variant is compiled after a copy of ``csrc/rglru.cu``,
checked against ``ref.rglru_ref`` (each row within ``rglru.STEP_TOL`` of
its peak, two launches bit-identical) at B 3, R 296 and at R 4096, then
timed with ``chip_smoke.paired_batches`` beside ``ops.rglru``'s kernel at
B 8, 1, 16 and 8 again, with a written and with a read-filled L2 (ms of
one call: median [min-max] of 7 batches of 50).  Needs one card and
``nvcc``; builds into ``build/ring`` (ignored).  Run from the repository's
root: ``python3 scripts/rglru_step_ring/time_ring.py``.
"""
import ctypes
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build as B, ref  # noqa: E402
from repro_torch.kernels.rglru import STEP_TOL, rglru  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
PROMO = {"p256": "CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
         "pnone": "CU_TENSOR_MAP_L2_PROMOTION_NONE"}
#: name -> (source, rows a stage, stages, L2 promotion or None)
VARIANTS = {"ring_k256_s3": ("ring.cu", 256, 3, None)}
for kt, s, p in ((128, 4, "p256"), (128, 4, "pnone"), (256, 3, "pnone"),
                 (128, 6, "pnone"), (64, 8, "pnone")):
    VARIANTS[f"ws_k{kt}_s{s}_{p}"] = ("ring_ws.cu", kt, s, PROMO[p])


def build_all() -> dict:
    base = (B.CSRC / "rglru.cu").read_text()
    out_dir = ROOT / "build" / "ring"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, kt, s, promo) in VARIANTS.items():
        text = (base + f"\n#define TMA_KT {kt}\n#define TMA_S {s}\n"
                + (f"#define TMA_PROMO {promo}\n" if promo else "")
                + (HERE / src).read_text())
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [B.nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "spill" in line and " 0 bytes spill" not in line:
                print(name, line.strip())
        if proc.returncode != 0:
            raise SystemExit(f"{name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = (lib.rglru_step_tmaw_launch if name.startswith("ws")
              else lib.rglru_step_tma_launch)
        fn.argtypes = [P] * 6 + [I] * 3 + [P]
        fn.restype = I
        fns[name] = fn
    return fns


def call(fn, args, h) -> None:
    conv, w_r, w_i, lam, h0 = args
    err = fn(conv.data_ptr(), w_r.data_ptr(), w_i.data_ptr(), lam.data_ptr(),
             h0.data_ptr(), h.data_ptr(), conv.shape[0], conv.shape[2], 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: {err}")


def main() -> None:
    C.probe()
    t0 = time.perf_counter()
    fns = build_all()
    print(f"variants built in {time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for b, r in ((3, 296), (8, 4096), (1, 4096), (16, 4096), (8, 4096)):
        args = C.rglru_case(gen, b, 1, r, torch.bfloat16)
        want = ref.rglru_ref(*args)
        cands = {"regs": lambda args=args: rglru(*args)}
        gaps = {"regs": C.row_gap(rglru(*args), want)}
        for name, fn in fns.items():
            h, again = torch.empty_like(want), torch.empty_like(want)
            call(fn, args, h)
            call(fn, args, again)
            torch.cuda.synchronize()
            gaps[name] = C.row_gap(h, want)
            if not (gaps[name] <= STEP_TOL and h.equal(again)):
                raise SystemExit(f"B {b} R {r} {name}: row gap "
                                 f"{gaps[name]:.3g}, two launches equal "
                                 f"{bool(h.equal(again))}")
            cands[name] = lambda fn=fn, h=h, args=args: call(fn, args, h)
        print(f"B {b} R {r}: worst row / row peak " + ", ".join(
            f"{n} {g:.3g}" for n, g in gaps.items())
            + "; two launches of each variant bit-identical", flush=True)
        if r != 4096:
            continue
        names = list(cands)
        for fill in ("write", "read"):
            res = C.paired_batches([cands[n] for n in names], n=50, reps=7,
                                   fill=fill)
            print(f"B {b} L2 {fill}-filled, ms: " + ", ".join(
                f"{n} {statistics.median(x):.5f} [{min(x):.5f}-{max(x):.5f}]"
                for n, x in zip(names, res)) + f" [{C.CARD}]", flush=True)
    print(f"ring variants: {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
