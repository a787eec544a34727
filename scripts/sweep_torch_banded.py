"""Dense against banded damped solve of the stage-8 normal equations on the GPU.

The port's counterpart of ``bench.py::measure_banded``. For each cut of
chip_smoke.py's DS3 recording (60 / 120 / 180 / 240 / 300 / 360 s, D ~
5.7k / 11.4k / 17.0k / 22.7k / 28.4k / 34.0k; the JAX package's sweep
stopped at 300 s) it builds the problem on the card, linearizes it once at
the truth-seeded initial point with the fast linearizer, masks it with the
default flags, and times, on the same (H, g, lambda = 1e-4):

* the dense Jacobi-equilibrated Cholesky ``solver/lm._solve_damped``;
* the banded solve ``solver/banded.make_banded_solver``;

each as the best of ``--reps`` rounds of CUDA-event timing around one call
(the banded solve is a host loop of small launches, so its event time is
also its host time). It checks that the two steps agree, prints a table,
the crossover (the first D where banded wins, interpolated linearly in D
between the two sweep points around the sign change of dense - banded),
and the card's name and power limit; each row also as a JSON line.

Usage (needs one CUDA device): python scripts/sweep_torch_banded.py [--reps 3]
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from openimucameracalibrator_torch.core import spline_estimator as se  # noqa: E402
from openimucameracalibrator_torch.solver import banded, lm  # noqa: E402
from openimucameracalibrator_torch.utils import precision  # noqa: E402

DURATIONS = (60.0, 120.0, 180.0, 240.0, 300.0, 360.0)
LAM = 1e-4


def best_ms(fn, reps):
    """Best of ``reps`` single calls, each timed with CUDA events after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def measure(duration, reps, dev):
    t0 = time.perf_counter()
    p, params, _ = cs.ds3_problem(duration, dev)
    layout = se.build_layout(p)
    lin, _ = se.make_solver_functions_fast(p, layout)
    H, g, _ = lin(params)
    mask = layout.free_mask(se.flags_to_fixed(se.DEFAULT_FLAGS), dtype=H.dtype, device=dev)
    H, g = lm._mask_system(H, g, mask)
    del lin
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lam = torch.tensor(LAM, dtype=H.dtype, device=dev)
    t1 = time.perf_counter()
    struct = banded.from_problem(layout, p, se.ORDER)
    struct_s = time.perf_counter() - t1
    solve_b = banded.make_banded_solver(struct)
    d_dense = lm._solve_damped(H, g, lam)
    d_band = solve_b(H, g, lam)
    rel = float(torch.linalg.vector_norm(d_band - d_dense)
                / torch.linalg.vector_norm(d_dense))
    dense_ms = best_ms(lambda: lm._solve_damped(H, g, lam), reps)
    band_ms = best_ms(lambda: solve_b(H, g, lam), reps)
    dense_ms2 = best_ms(lambda: lm._solve_damped(H, g, lam), reps)
    K, smax = struct.idx.shape
    row = dict(duration_s=duration, D=int(layout.tangent_dim), slabs=int(K), slab_max=int(smax),
               tail=int(struct.tail.shape[0]), dense_ms=min(dense_ms, dense_ms2),
               banded_ms=band_ms, rel_diff=rel, from_problem_s=struct_s, setup_s=setup_s)
    print(json.dumps(row), flush=True)
    del H, g, d_dense, d_band
    torch.cuda.empty_cache()
    return row


def crossover(rows):
    """First D where banded is faster, interpolated in D between the sweep
    points around the sign change of dense - banded; None if banded never
    wins in the sweep."""
    prev = None
    for r in rows:
        diff = r["dense_ms"] - r["banded_ms"]
        if diff > 0:
            if prev is None:
                return r["D"]
            pd, pdiff = prev["D"], prev["dense_ms"] - prev["banded_ms"]
            return int(round(pd + (r["D"] - pd) * (-pdiff) / (diff - pdiff)))
        prev = r
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = precision.resolve_device("cuda")
    name, smi = torch.cuda.get_device_name(0), cs.smi_line()
    print(f"{name}; nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    rows = [measure(d, args.reps, dev) for d in DURATIONS]
    cross = crossover(rows)
    print(f"{'D':>7} {'slabs':>6} {'dense ms':>10} {'banded ms':>10} {'rel diff':>10}")
    for r in rows:
        print(f"{r['D']:>7} {r['slabs']:>6} {r['dense_ms']:>10.3f} {r['banded_ms']:>10.3f} "
              f"{r['rel_diff']:>10.2e}")
    print(f"banded faster from D = {cross} (lambda {LAM}, float32, {smi})")
    bad = [r for r in rows if not r["rel_diff"] < 1e-3]
    if bad:
        raise SystemExit(f"banded and dense steps disagree: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
