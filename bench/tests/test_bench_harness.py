"""The harness: files found by name, the contract of BENCHMARK.json, the
shape of the last line, the refusal without a card, the import check."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

from bench_small import BENCH, run_small
from benchlib import guard, harness

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_JSON = harness.benchmark()
WORKLOADS = [w["name"] for w in BENCH_JSON["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_file_of_a_cell_is_found_by_name(workload):
    w = harness.workload_of(BENCH_JSON, workload)
    entry = next(c for c in BENCH_JSON["configs"] if c["name"] == w["config"])
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == w["config"]
    driver = harness.load_module("drivers", cfg["driver"])
    for fn in ("program_steps", "judge", "work", "scale"):
        assert callable(getattr(driver, fn))
    for fn in ("follow",):
        assert callable(getattr(harness.load_module("reference",
                                                    w["config"]), fn))
    assert callable(harness.load_module("counts", w["config"]).step)
    traffic = harness.load_json("traffic", f"{w['traffic']}.json")
    assert traffic["flgw_groups"] >= 1
    limits = harness.load_json("limits", f"{workload}.json")
    assert limits and all(v > 0 for v in limits.values())
    for e in harness.for_cell(BENCH_JSON["per_layer"], workload):
        assert callable(harness.metric_reader(e["name"]).read)


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and NAME.match(c["name"])
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {e["name"] for e in b["end_to_end"]}
    assert "setup_s" in e2e
    for e in b["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25 and UNIT.match(e["unit"])
    layers = {}
    for e in b["per_layer"]:
        assert e["moves"] in e2e and UNIT.match(e["unit"])
        assert set(e["workloads"]) <= cells
        layers.setdefault(e["layer"], []).append(e["name"])
    for cell in cells:
        reported = harness.for_cell(b["end_to_end"], cell)
        assert any(e["name"] != "setup_s" for e in reported)
        assert harness.for_cell(b["per_layer"], cell)
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


def test_the_last_line_has_the_driver_keys_and_the_compared_numbers_last():
    line = run_small("ic3net_pp_medium.learn_dense")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}
    assert set(line["compared"]) == set(
        harness.load_json("limits", "ic3net_pp_medium.learn_dense.json"))
    assert "first_loss_gap" in line["detail"]["uncompared"]
    json.loads(json.dumps(harness._finite(line)))


def test_the_verdict_holds_the_numbers_the_limits_name():
    got = {"a": 1.0, "b": 5.0, "_worst": "x"}
    assert harness.verdict(got, {"a": 2.0}) is True
    assert harness.verdict(got, {"a": 2.0, "b": 4.0}) is False
    assert harness.verdict({"a": float("nan")}, {"a": 2.0}) is False
    with pytest.raises(ValueError):
        harness.verdict(got, {"c": 1.0})


def test_a_run_without_a_card_exits_nonzero_and_prints_nothing():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in guard.FORBIDDEN, (path, name)


def test_the_references_import_nothing_of_the_port():
    plain = [*(BENCH / "reference").glob("*.py"),
             BENCH / "benchlib" / "plain.py",
             BENCH / "benchlib" / "compare.py"]
    for path in plain:
        for name in _imports(path):
            assert name.split(".")[0] != "repro_torch", (path, name)


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(
        ["repro_torch", "repro_torch.marl", "jaxtyping", "reprox"]) == []
    assert guard.forbidden_modules(
        ["repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.argv=['x']; sys.path[:0]=['bench','src'];"
            "from bench_small_probe import go; go()")
    probe = BENCH / "tests" / "bench_small_probe.py"
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(probe.parent)))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
