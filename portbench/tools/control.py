"""The readings behind a serve cell's limit, at the cell's own size and
load, several seeds in one process:

- the program as the cell runs it: the widest and the mean gap of its
  served tokens under the float32 reference (the lower reading's runs),
  and in the same pass the float8 control put in the program's place:
  the gaps of the tokens that the reference computed in float8 puts
  first, held to the cell's limits by the harness's own check, whose
  verdict is printed as ``control_correct`` (false, for a limit that
  separates the two);
- with ``--int8``, the program's own lower-precision path, int8 KV pools
  (``ServeConfig.kv_dtype="int8"``), read the same way.

    python3 portbench/tools/control.py --workload qwen2-7b.chat \
        --seeds 11 12 13 --seconds 10 --int8
"""

from __future__ import annotations

import argparse
import json

from common import context


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args()
    from portbench.lib import spec
    for seed in args.seeds:
        runs = [("native", dict(fp8_control=True))]
        if args.int8:
            runs.append(("int8", dict(kv_dtype="int8")))
        for name, kw in runs:
            ctx = context(args.workload, seed, args.seconds, trace=False,
                          **kw)
            out = spec.module("traffic", ctx.mix["kind"]).run(ctx)
            chk = out["check"]
            verdict = ({"control_correct": chk["correct"]}
                       if name == "native" else {"correct": chk["correct"]})
            print(json.dumps(dict(seed=seed, run=name, **verdict,
                                  numbers=chk["numbers"],
                                  **chk["readings"],
                                  peak=out["memory_peak"],
                                  frames=out["pool"]["frames"],
                                  failed=out["failed"], e2e=out["e2e"])),
                  flush=True)


if __name__ == "__main__":
    main()
