"""Knee sweep of an open-loop cell: one engine, built once, serves the
cell's mix at each of ``--rates`` in turn (a window of ``--seconds``
each, after the mix's lead-in, drained before the next rate), and prints
a JSON line a rate: the tails, how late the generator ran, the queue at
the window's close and the median TTFT of the window's first and second
half (a backlog that grows shows as the second above the first).

    python3 portbench/tools/sweep.py --workload qwen2-7b.chat \
        --rates 6 8 10 12 --seconds 20 --seed 1
"""

from __future__ import annotations

import argparse
import json
import time

from common import context


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    from portbench.lib import serve, spec
    ctx = context(args.workload, args.seed, args.seconds, trace=False)
    eng, params, model, pool = serve.build(ctx)
    rec = serve.Recorder(eng)
    gen = spec.module("traffic", ctx.mix["kind"])
    serve.warm(rec, gen.schedule(ctx.mix, ctx.dims["vocab"], args.seed,
                                 args.seconds)["warmup"])
    base = ctx.mix
    for k, rate in enumerate(args.rates):
        ctx.mix = dict(base, rate_rps=rate)
        sched = gen.schedule(ctx.mix, ctx.dims["vocab"], args.seed + k,
                             args.seconds)
        rec = serve.Recorder(eng)
        t = time.perf_counter()
        out = serve.open_loop(ctx, sched, rec)
        while eng.scheduler.has_work:
            rec.step()
        c = out["record"]["counters"]
        print(json.dumps(dict(
            rate_rps=rate, **out["e2e"], attempted=out["attempted"],
            failed=out["failed"], **out["notes"],
            decode_tokens=c.get("decode_tokens", 0),
            preemptions=c.get("preemptions", 0),
            skipped=c.get("prefill_tokens_skipped", 0),
            prefilled=c.get("prefill_tokens", 0)
            + c.get("continuation_prefill_tokens", 0),
            wall_s=time.perf_counter() - t)), flush=True)


if __name__ == "__main__":
    main()
