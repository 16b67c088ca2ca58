"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W power limit); a run prints the card's own power limit beside
them."""

BF16_FLOPS = 989e12          # FLOP/s, bf16 tensor cores, dense
HBM_BYTES = 3.35e12          # B/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: the larger of its
    operations over peak FLOP/s and its bytes over peak bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
