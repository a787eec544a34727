"""Run one benchmark cell on the card and print its result line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, kernel loads, the cell's inputs made from the seed, one
warm item) is timed as ``setup_s``; then the window runs for ``--seconds``;
then the program's answers are held against the plain reference. With
``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` the window is followed by one traced item, and the metrics
are the cell's per-layer metrics, read by ``benchmarks/metrics/<name>.py``.
The last line of standard output is one JSON object; the numbers compared
with the reference, each beside its limit, close standard error and the
result line. Exits non-zero, printing no result, without the CUDA devices
the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "openimucameracalibrator_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: str):
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own ``.so`` builds already go to ``csrc/build`` there)."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def compare(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}) for the
    numbers the cell's limits file names."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        v = float(v) if v is not None and math.isfinite(float(v)) else math.inf
        out[name] = {"value": v if math.isfinite(v) else "inf", "limit": limit}
        ok &= v <= limit
    return ok, out


def _sync(cell):
    if cell.device == "cuda":
        import torch

        torch.cuda.synchronize()


def execute(cell, bench: dict, seconds: float, traced: bool, t_start: float) -> dict:
    """Set-up, window, (traced item,) comparison: the result object. Runs on
    ``cell.device``; ``main`` has checked for the card before."""
    from benchmarks.harness import cell as cell_mod
    from benchmarks.harness import device

    on_card = cell.device == "cuda"
    entry = cell_mod.entry(cell)
    state = entry.setup(cell)
    _sync(cell)
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s", file=sys.stderr, flush=True)

    if on_card:
        device.log_clocks("before the window")
    win = entry.window(state, seconds)
    _sync(cell)
    if on_card:
        device.log_clocks("after the window")
    answers = list(win["answers"])
    if traced:
        from benchmarks.harness import trace

        (answer, calls), tr = trace.profile(lambda: entry.traced_item(state, len(answers)),
                                            cuda=on_card)
        answers.append(answer)
        run = {"cell": cell, "window": win, "answers": answers, "trace": tr, "calls": calls,
               "kind": device.kind(cell.device)}
        metrics = {}
        for m in cell_mod.per_layer(bench, cell.name):
            v = cell_mod.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell_mod.end_to_end(bench, cell.name):
            if m["name"] in win["metrics"]:
                metrics[m["name"]] = {"value": win["metrics"][m["name"]], "unit": m["unit"]}
    dev = device.info(cell.chips, cell.device)
    if traced:
        dev["busy_s"] = tr.union_s()
        dev["window_s"] = tr.window_s

    values = entry.check(state, answers)
    entry.release(state)
    ok, compared = compare(values, cell.limits)
    failed = int(win.get("failed", 0))
    result = {"correct": bool(ok and failed == 0), "attempted": int(win["attempted"]),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from benchmarks.harness import cell as cell_mod
    from benchmarks.harness import device

    cache_dirs(cell_mod.ROOT)
    bench = cell_mod.benchmark()
    cell = cell_mod.load(args.workload, args.seed)
    device.require_cuda(cell.chips)
    result = execute(cell, bench, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
