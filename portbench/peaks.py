"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its 700 W
limit (NVIDIA's data sheet), and the roofline arithmetic against them."""

PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the float32
    operations over the float32 peak and the bytes over the HBM peak."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
