"""The bf16 compact products' share of their roofline: the least time
of the forward compact products the model defines over the device time
of the forward launches of the kernels that run them (their
recomputation in the backward left out), in %."""
from benchlib import readers

KERNELS = ("grouped_bmm_tma_kernel", "grouped_bmm_bf16_kernel")


def read(ctx):
    return readers.roofline_percent(ctx, KERNELS)
