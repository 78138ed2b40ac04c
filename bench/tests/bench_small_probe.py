"""Runs every cell once at its small size on the CPU, then prints the
forbidden modules the process loaded (a list, ``[]`` when none)."""
from bench_small import run_small
from benchlib import guard, harness


def go():
    for w in harness.benchmark()["workloads"]:
        run_small(w["name"], seconds=0.2)
    print(guard.forbidden_modules())
