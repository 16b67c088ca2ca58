"""Run one cell several times, one process a run, one seed each, and write
a JSON line a run (seed, exit code, result, the end of standard error):

    python3 portbench/tools/sets.py --workload qwen2-7b.chat \
        --seeds 1 2 3 4 5 6 --seconds 30 --trace 0 --out runs.jsonl
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    with open(args.out, "a") as f:
        for seed in args.seeds:
            t = time.perf_counter()
            p = subprocess.run(
                [sys.executable, str(ROOT / "portbench" / "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True, timeout=1500)
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                res = None
            row = dict(workload=args.workload, seed=seed, trace=args.trace,
                       rc=p.returncode, wall_s=time.perf_counter() - t,
                       result=res, stderr=p.stderr[-3000:])
            f.write(json.dumps(row) + "\n")
            f.flush()
            m = res["metrics"] if res else None
            print(json.dumps(dict(seed=seed, rc=p.returncode,
                                  correct=res and res["correct"],
                                  metrics={k: v["value"] for k, v in
                                           (m or {}).items()},
                                  check=res and {k: v["value"] for k, v in
                                                 res["check"].items()})),
                  flush=True)


if __name__ == "__main__":
    main()
