"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the machine it is started on and
prints one JSON object as the last line of its standard output (see
``bench/README.md``). It needs a CUDA card and exits non-zero without
one.
"""
import time

T_START = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from benchlib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
