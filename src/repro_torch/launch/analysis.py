"""Collective statistics and roofline terms of a dry-run cell (port of
``src/repro/launch/hlo_analysis.py``), on the H100 constants of
``core/costmodel.py``.

Convention (JAX's): the collective bytes are the bytes **received per
rank**, each collective's output (all-gather: the gathered size;
all-reduce: the whole tensor; reduce-scatter / all-to-all: the output).
A ring all-reduce moves about twice that.

JAX's ``shape_bytes`` and ``parse_collectives`` read HLO text; the port
has none.  ``launch/op_cost.py`` counts each collective as it dispatches
and fills :class:`CollectiveStats` from that.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.costmodel import (H100_HBM_BW, H100_NET_BW,
                                        H100_PEAK_FLOPS_BF16)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    bytes_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class RooflineTerms:
    """Per-rank roofline terms, seconds (H100 constants)."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float            # per rank
    hlo_bytes: float            # per rank
    collective_bytes: float     # per rank
    model_flops: float          # global 6·N·D (or 2·N·D serve)
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips): remat/redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU at the roofline: model-flops time / bound time."""
        ideal = self.model_flops / (self.chips * H100_PEAK_FLOPS_BF16)
        return ideal / self.bound_s if self.bound_s else float("nan")

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hlo_flops_per_device": self.hlo_flops,
            "hlo_bytes_per_device": self.hlo_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def roofline(
    cost: dict,
    coll: CollectiveStats,
    *,
    chips: int,
    model_flops: float,
) -> RooflineTerms:
    """cost: ``{"flops", "bytes accessed"}`` of one rank (``op_cost``'s
    counts are a rank's already)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return RooflineTerms(
        compute_s=flops / H100_PEAK_FLOPS_BF16,
        memory_s=byts / H100_HBM_BW,
        collective_s=coll.total_bytes / H100_NET_BW,
        hlo_flops=flops,
        hlo_bytes=byts,
        collective_bytes=float(coll.total_bytes),
        model_flops=model_flops,
        chips=chips,
    )


def fmt_seconds(s: float) -> str:
    if s == 0 or math.isnan(s):
        return "0"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6)):
        if s >= scale:
            return f"{s / scale:.3g}{unit}"
    return f"{s:.2e}s"
