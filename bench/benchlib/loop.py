"""A training cell's run: set-up, the window (or the traced steps), the
comparison. A driver (``bench/drivers/<name>.py``) gives:

* ``program_steps(cell)`` -> (program, readings, inputs): the program
  built from the seed after its first steps, ``program.step()`` ->
  (loss, inputs) running one more through the same call, and
  ``program.hist()`` the realised masks' group sizes for the counts;
* ``judge(cell, readings, inputs)`` -> the numbers compared;
* ``METRIC`` and ``work(config, traffic)``: the end-to-end rate's name
  and the work one step does (env steps, tokens).
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from benchlib import trace as trace_lib


def _spread(ms: list) -> dict:
    """Quartiles of the window's step times, and its two halves' means
    (whether the rate drifted within the run)."""
    q = statistics.quantiles(ms, n=4) if len(ms) > 1 else ms * 3
    half = len(ms) // 2
    return {"min": min(ms), "q1": q[0], "median": q[1], "q3": q[2],
            "max": max(ms),
            "halves": [statistics.fmean(ms[:half] or ms),
                       statistics.fmean(ms[half:])]}


def run(cell, driver) -> dict:
    prog, measured, inputs = driver.program_steps(cell)
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t_win = time.perf_counter()
    out = {"setup_s": t_win - cell.t_start,
           "detail": {"setup_phases": measured["phases"]}}
    losses, ends = [], []

    def step():
        losses.append(prog.step()[0])
        ends.append(time.perf_counter())

    if cell.trace:
        hist = prog.hist()
        out["window"] = trace_lib.record(step, cell.traffic["trace_iters"])
        out["count"] = cell.counts.step(cell.config, cell.traffic, hist)
    else:
        while True:
            step()
            if time.perf_counter() - t_win >= cell.seconds:
                break
        elapsed = time.perf_counter() - t_win
        out[driver.METRIC] = len(losses) \
            * driver.work(cell.config, cell.traffic) / elapsed
        out["detail"]["step_ms"] = _spread(
            [1e3 * (b - a) for a, b in zip([t_win] + ends, ends)])
    out["attempted"] = len(losses)
    out["failed"] = sum(not math.isfinite(x) for x in losses)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(cell.device)
                         if on_card else 0)
    del prog, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cell.device)
    t_ref = time.perf_counter()
    out["compared"] = driver.judge(cell, measured, inputs)
    out["detail"]["reference_s"] = time.perf_counter() - t_ref
    if on_card:
        out["detail"]["reference_peak_bytes"] = \
            torch.cuda.max_memory_allocated(cell.device)
    return out
