"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  A share of a peak is
stated against these, with the card's power limit beside it."""

BF16_FLOPS = 989e12      # tensor cores, bf16 and fp16
HBM_BYTES = 3.35e12      # HBM3, bytes per second


def least_seconds(flops: float, n_bytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    return max(flops / BF16_FLOPS, n_bytes / HBM_BYTES)
