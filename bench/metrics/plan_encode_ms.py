"""Device ms an iteration or step of the plan encode's kernels."""
from benchlib import readers


def read(ctx):
    return readers.device_ms_per_iter(ctx, readers.PLAN_ENCODE)
