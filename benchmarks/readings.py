"""Readings that the comparison's limits are set from: the compared numbers
of the program as it ships (``sound``) and of the control and each planted
fault (``benchmarks/faults.py``), at a cell's own size, on several seeds,
in one process.

    python3 benchmarks/readings.py --workload gopro9_ds3.calibrate \\
        --variants sound gs frozen --seeds 101 102 103 --out readings.jsonl

Each (variant, seed) makes the cell's inputs from the seed and runs every
input of the pool once through the entry (``reading``: each recording of a
calibrate cell, the batch item, each frame of the detect pool), then prints
one JSON line with every number the reference computes, and whether the
numbers of the cell's limits file hold (``correct``, and the names of those
that do not under ``over``). Variants other than ``sound`` run on the first
``CONTROL_SEEDS`` seeds only. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONTROL_SEEDS = 3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--variants", nargs="+", default=["sound"])
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from benchmarks import run
    from benchmarks.harness import cell as cell_mod
    from benchmarks.harness import device

    run.cache_dirs(cell_mod.ROOT)
    base = cell_mod.load(args.workload, args.seeds[0])
    device.require_cuda(base.chips)
    entry = cell_mod.entry(base)
    entry.setup(base)  # builds and warms once for the whole process
    for variant in args.variants:
        for seed in args.seeds if variant == "sound" else args.seeds[:CONTROL_SEEDS]:
            cell = cell_mod.load(args.workload, seed)
            cell.variant = "" if variant == "sound" else variant
            t0 = time.perf_counter()
            state = entry.prepare(cell)
            values = entry.check(state, entry.reading(state))
            entry.release(state)
            ok, compared = run.compare(values, cell.limits)
            line = json.dumps({"workload": args.workload, "variant": variant, "seed": seed,
                               "seconds": time.perf_counter() - t0, "correct": ok,
                               "over": [k for k, c in compared.items()
                                        if c["value"] == "inf" or c["value"] > c["limit"]],
                               **values})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
