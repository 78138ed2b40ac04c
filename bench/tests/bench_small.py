"""Small sizes of the benchmark's configurations for the CPU tests: the
files' own values with the widths and the batch cut so that a test run
holds them (the cells run at the files' sizes on the card)."""
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import torch  # noqa: E402

from benchlib import harness  # noqa: E402

SEED = 2 ** 31 + 12345          # the driver's seeds pass 32 bits


def small(workload: str):
    """(config, traffic) of ``workload`` at a CPU test's size."""
    w = harness.workload_of(harness.benchmark(), workload)
    entry = next(c for c in harness.benchmark()["configs"]
                 if c["name"] == w["config"])
    cfg = harness.load_json(*Path(entry["file"]).parts[1:])
    traffic = harness.load_json("traffic", f"{w['traffic']}.json")
    if cfg["driver"] == "marl_learner":
        cfg["model"].update(hidden=32, n_agents=3, size=5, obs_dim=20,
                            max_steps=8)
        traffic = dict(traffic, batch=16)
    else:
        cfg["model"].update(d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128, vocab=512, n_experts=4,
                            moe_d_ff=128, n_layers=2)
        traffic = dict(traffic, batch=2, seq=32)
    return cfg, traffic


def run_small(workload: str, seconds: float = 0.5, seed: int = SEED,
              **kw) -> dict:
    """A whole run of ``workload`` at its small size on the CPU: the
    harness's look for a card skipped, the rest as on the card."""
    torch.set_num_threads(2)
    cfg, traffic = small(workload)
    return harness.execute(workload, seed, seconds, False,
                           torch.device("cpu"), time.perf_counter(),
                           config=cfg, traffic=traffic, **kw)
