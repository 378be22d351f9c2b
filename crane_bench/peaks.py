"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12   # bf16 / fp16 tensor-core FLOP/s
TF32_FLOPS = 494.7e12  # TF32 tensor-core FLOP/s
HBM_BYTES_S = 3.35e12  # HBM3 bytes/s


def least_seconds(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time a piece of work can take: the larger of its operations
    at the peak rate and its bytes at the peak bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_S)
