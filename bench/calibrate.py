"""The readings a cell's limits are set from, on the card, at the cell's
own size (not run by the benchmark's runs).

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --controls 101 102 103 [--out chiprun_out/calibrate.json]

For each ``--seeds`` seed: the program's first steps as a run's set-up
makes them, judged by the reference: the lower readings. For each
``--controls`` seed: the reference computed in the configuration's
``control`` precision put in the program's place (drawing its own
decisions from the same inputs), judged by the float32 reference: the
control's readings; and the reference with half of the batch left out
(the mean over the rest) in the program's place: that fault's readings.
A step that leaves the state unchanged reads 1 on ``grad_gap`` and
``change_gap`` by their definition and needs no run. Each reading is
judged by the cell's limits (``bench/limits/<cell>.json``, where there
is one) with the harness's own ``verdict``, and printed with its
``correct``: sound runs have to read true, the control and the fault
false.
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

from benchlib import harness, weights  # noqa: E402


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _public(compared: dict) -> dict:
    return {k: v for k, v in compared.items() if not k.startswith("_")}



def readings(workload: str, seeds, controls, device, *, config=None,
             traffic=None, limits=None) -> dict:
    """The readings of ``workload``; ``config``, ``traffic`` and
    ``limits`` override its files (the tests' small sizes). Each
    reading carries ``correct`` by the limits (None without any)."""
    bench = harness.benchmark()
    w = harness.workload_of(bench, workload)
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    if config is None:
        with open(ROOT / entry["file"]) as f:
            config = json.load(f)
    traffic = traffic or harness.load_json("traffic", f"{w['traffic']}.json")
    if limits is None and (harness.BENCH / "limits"
                           / f"{workload}.json").is_file():
        limits = harness.load_json("limits", f"{workload}.json")

    def judged(got):
        got["correct"] = None if limits is None else \
            harness.verdict(got, limits)
        return got

    driver = harness.load_module("drivers", config["driver"])
    ref = harness.load_module("reference", w["config"])

    def cell(seed):
        return harness.Cell(workload=workload, config=config,
                            traffic=traffic, seed=seed, seconds=0.0,
                            trace=False, device=device,
                            t_start=time.perf_counter(), reference=ref,
                            counts=None)

    out = {"workload": workload, "control": config["control"],
           "program": {}, "control_runs": {}, "half_batch": {}}
    for seed in seeds:
        c = cell(seed)
        prog, measured, inputs = driver.program_steps(c)
        del prog
        _free()
        got = judged(driver.judge(c, measured, inputs))
        out["program"][seed] = got
        print(workload, "program", seed, _public(got), flush=True)
        _free()
    for seed in controls:
        c = cell(seed)
        prog, measured, inputs = driver.program_steps(c)
        del prog
        _free()
        for key, kw in (("control_runs", dict(precision=config["control"])),
                        ("half_batch", dict(half_batch=True))):
            p0 = weights.make(measured["shapes"], seed, device, driver.scale)
            put = ref.follow(config, traffic, p0, inputs, own=True, **kw)
            del p0
            put["shapes"] = measured["shapes"]
            _free()
            got = judged(driver.judge(c, put, put["inputs"]))
            out[key][seed] = got
            print(workload, key, seed, _public(got), flush=True)
            del put
            _free()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    got = readings(a.workload, a.seeds, a.controls, torch.device("cuda", 0))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(got, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
