"""BENCHMARK.json as data: names, units and lengths the harness and its
readers rely on, and that every part of a cell is found by name."""

from __future__ import annotations

import os
import re

import pytest

from benchmarks.harness import cell as cell_mod

BENCH = cell_mod.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS])
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_part_of_a_cell_is_found_by_name(w):
    cell = cell_mod.load(w["name"], 1, device="cpu")
    assert cell.limits and cell.traffic["entry"]
    assert cell_mod.entry(cell).check
    e2e = cell_mod.end_to_end(BENCH, w["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = cell_mod.per_layer(BENCH, w["name"])
    assert layer
    # Each per-layer metric's `moves` is an end-to-end metric this cell reports.
    for m in layer:
        assert m["moves"] in {x["name"] for x in e2e}, (m["name"], w["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(m):
    assert callable(cell_mod.reader(m["name"]))
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    # The harness picks a cell's per-layer metrics by this list alone.
    assert m["workloads"]
    for w in m["workloads"]:
        assert w in {x["name"] for x in BENCH["workloads"]}


def test_configs_live_under_paths_and_name_their_reductions():
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = cell_mod.load_json(os.path.join(cell_mod.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        assert cfg["name"] == c["name"]
