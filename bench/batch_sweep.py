"""The sweep that fixed the IC3Net cells' env batch B (run once, on the
card; not run by the benchmark's runs).

    python3 bench/batch_sweep.py [--cells learn_g4 learn_dense] \
        [--batches 16384 32768 49152] [--seconds 10]

For each cell and B, two whole runs of the cell at that batch through
the harness (``execute``, as ``bench/run.py`` makes them): one timed
for ``--seconds``, one traced. Printed, one JSON line each: the peak of
allocated device memory, the reference's own peak after the program is
freed, the window's step times (quartiles), the rate, ``correct`` by
the cell's limits, and the traced run's device busy share.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

from benchlib import harness  # noqa: E402

CONFIG = "ic3net_pp_medium"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=["learn_g4", "learn_dense"])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[16384, 32768, 49152])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("batch_sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.set_num_threads(2)
    torch.zeros(1, device=dev)        # the allocator, before its stats
    for name in a.cells:
        workload = f"{CONFIG}.{name}"
        base = harness.load_json("traffic", f"{name}.json")
        for b in a.batches:
            row = {"cell": workload, "batch": b,
                   "card": torch.cuda.get_device_name(dev)}
            for trace in (False, True):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                try:
                    line = harness.execute(
                        workload, a.seed, a.seconds, trace, dev,
                        time.perf_counter(), traffic=dict(base, batch=b))
                except torch.OutOfMemoryError as e:
                    row["oom"] = str(e)[:200]
                    break
                d = line["detail"]
                if trace:
                    row["busy_share"] = (line["device"]["busy_s"]
                                         / line["device"]["window_s"])
                    row["traced"] = {k: v["value"]
                                     for k, v in line["metrics"].items()}
                    row["host_pass"] = d["host_pass"]
                else:
                    row.update(
                        peak_gb=line["device"]["memory_peak_bytes"] / 1e9,
                        reference_peak_gb=d["reference_peak_bytes"] / 1e9,
                        step_ms=d["step_ms"],
                        rate=line["metrics"]["env_steps_per_s"]["value"],
                        setup_s=line["metrics"]["setup_s"]["value"],
                        correct=line["correct"],
                        compared={k: v["value"]
                                  for k, v in line["compared"].items()})
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
