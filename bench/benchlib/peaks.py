"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W). The benchmark's yardstick: the roofline and MFU metrics
divide by these."""
F32_FLOPS = 67e12        # FLOP/s, float32 outside the tensor cores
BF16_FLOPS = 989e12      # FLOP/s, bf16 on the tensor cores, dense
HBM_BYTES = 3.35e12      # bytes/s, HBM3


def least_seconds(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take for work of ``flops`` at
    ``peak`` that moves ``nbytes`` of device memory."""
    return max(flops / peak, nbytes / HBM_BYTES)
