"""Device kernels a learner iteration, as the profiler records them:
fusion lowers it; a CUDA graph's replay would not."""
from benchlib.readers import kernels_per_iter as read  # noqa: F401
