"""The harness end to end on the CPU at tiny sizes: each cell's set-up,
window, traced item and comparison, and the result line's keys."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmarks import run
from benchmarks.harness import cell as cell_mod
from benchmarks.tests.conftest import tiny_cell

BENCH = cell_mod.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "openimucameracalibrator_tpu"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_cell_runs_end_to_end_on_the_cpu(name, traced):
    cell = tiny_cell(name)
    result = run.execute(cell, BENCH, 0.5, traced, run.time.perf_counter())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["compared"]) == set(cell.limits)
    json.dumps(result)
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
        want = {m["name"] for m in cell_mod.per_layer(BENCH, name) if m["source"] != "device_trace"}
        assert want <= set(result["metrics"])
    else:
        want = {m["name"] for m in cell_mod.end_to_end(BENCH, name)}
        assert set(result["metrics"]) == want
        assert all(m["value"] > 0 for m in result["metrics"].values())
    found = {m.split(".")[0] for m in sys.modules} & FORBIDDEN
    assert not found, found


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cell_mod.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
