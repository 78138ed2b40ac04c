"""The benchmark's own library: loading cells by name, weights and inputs
from the seed, the profiler's reduction to metrics, the comparison that
decides ``correct``. It imports nothing of the port at module level."""
