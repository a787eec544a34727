"""A cell as data: its entry in BENCHMARK.json, its configuration file, its
traffic file and its limits file, all found by name."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # benchmarks/configs/<config>.json
    traffic: dict         # benchmarks/traffic/<traffic>.json
    limits: dict          # benchmarks/limits/<cell>.json: {number: limit}
    chips: int
    seed: int
    device: str = "cuda"
    variant: str = ""     # "" for the program as it ships; else a control or fault


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load(name: str, seed: int, root: str = ROOT, device: str = "cuda") -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, config=load_json(os.path.join(root, cfg["file"])),
                traffic=load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
                limits=load_json(os.path.join(BENCH_DIR, "limits", name + ".json")),
                chips=int(w["chips"]), seed=int(seed), device=device)


def entry(cell: Cell):
    """The entry module that the traffic file names (``benchmarks/entries``)."""
    return importlib.import_module(f"benchmarks.entries.{cell.traffic['entry']}")


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics whose ``workloads`` list this cell."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str):
    """``read(run) -> float | None`` of ``benchmarks/metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
