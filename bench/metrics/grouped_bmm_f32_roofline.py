"""The float32 compact products' share of their roofline: the least
time of the forward compact products the model defines over the device
time of the forward launches of the kernel that runs them, in %."""
from benchlib import readers

KERNELS = ("grouped_bmm_f32_kernel",)


def read(ctx):
    return readers.roofline_percent(ctx, KERNELS)
