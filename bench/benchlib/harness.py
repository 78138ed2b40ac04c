"""One run of one cell: find its files by name, drive it, print the line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

* ``bench/configs/<config>.json``: the configuration as run; its
  ``driver`` names ``bench/drivers/<driver>.py``, which builds the port's
  system under test, runs set-up, the window and the comparison;
* ``bench/traffic/<traffic>.json``: the traffic mix's parameters;
* ``bench/reference/<config>.py``: the plain reference;
* ``bench/counts/<config>.py``: the FLOPs and bytes the MFU and roofline
  metrics divide by;
* ``bench/limits/<workload>.json``: each compared number's limit;
* ``bench/metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``
  returning a number or None (nothing to read: the metric is left out);
  a metric split by the end-to-end metric it moves (``mfu.marl``,
  ``mfu.lm``) is read by the file of its name up to the first dot
  (``mfu.py``) where it has none of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from types import ModuleType

from benchlib import guard, loop

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(*parts) -> dict:
    with open(Path(BENCH, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``bench/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    mod_name = f"bench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    else ``metrics/<name up to its first dot>.py``."""
    if (BENCH / "metrics" / f"{name}.py").is_file():
        return load_module("metrics", name)
    return load_module("metrics", name.split(".", 1)[0])


def verdict(compared: dict, limits: dict) -> bool:
    """``correct``: every number the limits name at or under its limit;
    a NaN is over any. The driver's other numbers are not compared."""
    missing = set(limits) - set(compared)
    if missing:
        raise ValueError(f"limits for {sorted(missing)}, which the "
                         f"driver does not give")
    return all(compared[k] <= v for k, v in limits.items())


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in bench['workloads']]}")


def for_cell(entries: list, workload: str) -> list:
    """The metric entries a cell reports."""
    return [e for e in entries if workload in e.get("workloads", [workload])]


@dataclasses.dataclass
class Cell:
    """What a driver is handed."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    reference: ModuleType
    counts: ModuleType


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader is handed: the traced window
    (``benchlib.trace.Window``), the count of one iteration (the counts
    module's dict: ``flops``, ``peak_flops``, ``compact_s``,
    ``compact_bwd_s``) and the peak of allocated device memory in
    bytes."""
    window: object
    count: dict
    peak_bytes: int


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, *, bench: dict = None, config: dict = None,
            traffic: dict = None, limits: dict = None,
            marks: dict = None) -> dict:
    """Run one cell and return its result line as a dict (``compared``
    last). ``bench``, ``config``, ``traffic`` and ``limits`` override the
    files (the tests' small sizes); ``marks``: seconds from ``t_start``
    to the set-up's first stages, shown in the line's ``detail``."""
    bench = bench or benchmark()
    w = workload_of(bench, workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    if config is None:
        with open(ROOT / cfg_entry["file"]) as f:
            config = json.load(f)
    traffic = traffic or load_json("traffic", f"{w['traffic']}.json")
    limits = limits or load_json("limits", f"{workload}.json")
    driver = load_module("drivers", config["driver"])
    marks = dict(marks or {}, program_imported_s=time.perf_counter() - t_start)
    cell = Cell(workload=workload, config=config, traffic=traffic, seed=seed,
                seconds=seconds, trace=trace, device=device, t_start=t_start,
                reference=load_module("reference", w["config"]),
                counts=load_module("counts", w["config"]))
    out = loop.run(cell, driver)

    if trace:
        ctx = Context(window=out["window"], count=out["count"],
                      peak_bytes=out["peak_bytes"])
        metrics = {}
        for e in for_cell(bench["per_layer"], workload):
            v = metric_reader(e["name"]).read(ctx)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        metrics = {e["name"]: {"value": out[e["name"]], "unit": e["unit"]}
                   for e in for_cell(bench["end_to_end"], workload)}

    correct = verdict(out["compared"], limits)
    uncompared = {k: v for k, v in out["compared"].items()
                  if k not in limits and not k.startswith("_")}
    import torch
    on_card = getattr(device, "type", str(device)) == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": out["peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        from benchlib import trace as trace_lib
        win = out["window"]
        dev["busy_s"], dev["window_s"] = win.busy_s, win.window_s
        line["breakdown"] = trace_lib.breakdown(win)
    if trace:
        out.setdefault("detail", {})["host_pass"] = out["window"].host_pass
    line["detail"] = dict(out.get("detail", {}), setup_marks=marks,
                          uncompared=uncompared,
                          **{k: v for k, v in out["compared"].items()
                             if k.startswith("_")})
    line["compared"] = {k: {"value": out["compared"][k], "limit": v}
                        for k, v in limits.items()}
    return line


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds its libraries into build/repro_torch by itself."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)


def _finite(x):
    """JSON has no NaN or infinity: such a number is written as a
    string."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = benchmark()
    chips = workload_of(bench, a.workload)["chips"]
    _cache_dirs()
    import torch
    marks = {"torch_imported_s": time.perf_counter() - t_start}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {a.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.zeros(1, device="cuda")
    marks["cuda_ready_s"] = time.perf_counter() - t_start
    line = execute(a.workload, a.seed, a.seconds, bool(a.trace),
                   torch.device("cuda", 0), t_start, bench=bench, marks=marks)
    found = guard.forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 3
    for k, v in line["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)
    return 0
