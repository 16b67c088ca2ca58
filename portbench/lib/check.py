"""The comparison that decides ``correct``.

Served cells: once the window has closed and the program's state is
freed, the plain reference runs over each sampled request's prompt with
the tokens it was served (teacher forcing), and at each served position
reads how far the served token's logit lies below the reference's best.
The widest such gap over the sample, and the mean over its served
tokens, are compared with the cell's limits (``limits/<cell>.json``:
each number it names is compared); so is the count of requests that
failed or never finished.  Greedy tokens only: every engine here serves
greedily.

With ``fp8`` the same pass also reads the control: at each position the
token that the reference computed in float8 (``reference/dense.py``'s
:class:`Fp8`) puts first, and its gap under the float32 reference.  The
control then stands in the program's place: its gaps, not the served
tokens', are the numbers held to the cell's limits, and ``correct`` is
the control's verdict (it has to come out false).  The served tokens'
gaps stay in the readings."""

from __future__ import annotations

import sys

import torch

from portbench.lib import spec


def limits(cell: str) -> dict:
    return spec.load_json(spec.PKG / "limits" / f"{cell}.json")


def gaps(ref, params: dict, dims: dict, samples, device,
         fp8: bool = False) -> dict:
    """The widest and the mean gap of the served tokens (and of the float8
    control's first choices) over ``samples``: ``[(prompt, served,
    admission), ...]``, ``admission`` the (rows, longest chunk) of the
    prefill call that admitted the request, kept in the per-request
    readings."""
    ref.exact()
    worst, total, n = 0.0, 0.0, 0
    worst8, total8 = 0.0, 0.0
    per = []
    with torch.no_grad():
        for prompt, served, admission in samples:
            seq = torch.as_tensor(
                list(prompt) + list(served[:-1]), device=device)
            at = torch.arange(len(prompt) - 1, len(seq), device=device)
            lg = ref.logits_at(params, dims, seq, at)
            tok = torch.as_tensor(served, device=device)
            best = lg.max(-1).values
            g = best - lg.gather(-1, tok[:, None])[:, 0]
            worst = max(worst, float(g.max()))
            total += float(g.sum())
            n += len(served)
            per.append(dict(prompt=len(prompt), served=len(served),
                            admission=admission, widest=float(g.max()),
                            mean=float(g.mean()),
                            mismatch=float((g > 0).float().mean())))
            if fp8:
                lo = ref.logits_at(params, dims, seq, at, prec=ref.Fp8)
                g8 = best - lg.gather(-1, lo.argmax(-1)[:, None])[:, 0]
                worst8 = max(worst8, float(g8.max()))
                total8 += float(g8.sum())
                per[-1].update(mean_fp8=float(g8.mean()),
                               mismatch_fp8=float((g8 > 0).float().mean()))
    out = dict(widest_gap=worst, mean_gap=total / max(n, 1), tokens=n,
               requests=len(samples), per_request=per)
    if fp8:
        out.update(widest_gap_fp8=worst8, mean_gap_fp8=total8 / max(n, 1))
    return out


def serve(ctx, params: dict, samples, failed: int) -> dict:
    ref = spec.module("reference", ctx.conf["reference"])
    read = gaps(ref, params, ctx.dims, samples, ctx.device,
                fp8=ctx.fp8_control)
    lim = ctx.limits or limits(ctx.cell["name"])
    judged = "_fp8" if ctx.fp8_control else ""
    numbers = {}
    for name in ("widest_gap", "mean_gap"):
        if name in lim:
            # no served token checked is no reading at all
            v = read[name + judged] if read["tokens"] else float("inf")
            numbers[name] = dict(value=v, limit=lim[name])
    numbers["failed_requests"] = dict(value=failed, limit=0)
    ok = all(v["value"] <= v["limit"] for v in numbers.values())
    return dict(correct=bool(ok), numbers=numbers, readings=read)


def report(numbers: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for k, v in numbers.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
