"""Where the port's DS3-scale LM iteration spends its time on the GPU.

Builds the 60 s DS3 recording of chip_smoke.py on the card
(``chip_smoke.ds3_problem``), then profiles one fused-LM iteration's work
(one linearization and one damped solve) with
``torch.profiler`` and prints:

* the wall time of the linearization and of the solve (CUDA events);
* device time by kernel name, top 25, and the device busy share of the
  profiled window;
* the device time of the fused Gram kernel against the whole
  linearization.

Usage (needs one CUDA device): python scripts/profile_torch_linearize.py
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from openimucameracalibrator_torch.core import spline_estimator as se  # noqa: E402
from openimucameracalibrator_torch.solver import lm  # noqa: E402
from openimucameracalibrator_torch.utils import precision  # noqa: E402


def main():
    dev = precision.resolve_device("cuda")
    p, params, _ = cs.ds3_problem(cs.DURATION, dev)
    layout = se.build_layout(p)
    lin, _ = se.make_solver_functions_fast(p, layout)
    mask = layout.free_mask(se.flags_to_fixed(se.DEFAULT_FLAGS), dtype=torch.float32,
                            device=dev)

    def step():
        H, g, c = lin(params)
        H, g = lm._mask_system(H, g, mask)
        return lm._solve_damped(H, g, 1e-4)

    lin_ms = cs.cuda_ms(lambda: lin(params), warm=2, reps=5)
    H, g, _ = lin(params)
    H, g = lm._mask_system(H, g, mask)
    solve_ms = cs.cuda_ms(lambda: lm._solve_damped(H, g, 1e-4), warm=2, reps=10)
    print(f"{torch.cuda.get_device_name(0)}; {cs.smi_line()}")
    print(f"D={layout.tangent_dim}: linearize {lin_ms:.2f} ms, damped solve {solve_ms:.2f} ms "
          "(CUDA events)")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda]
    rows.sort(key=lambda e: -e.self_device_time_total)
    kernels = [e for e in prof.events() if e.device_type == cuda]
    busy_us = sum(e.device_time for e in kernels)
    total = sum(e.self_device_time_total for e in rows)
    if not rows:
        print("the profiler recorded no device time; use the CUDA-event times above")
    print(f"profiled 3 x (linearize + solve): wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / (wall * 1e3):.1f} %), "
          f"{len(kernels)} kernel launches")
    print(f"{'device ms':>10} {'calls':>6}  name")
    for e in rows[:25]:
        print(f"{e.self_device_time_total / 1e3:10.3f} {e.count:6d}  {e.key[:100]}")
    gram_us = sum(e.self_device_time_total for e in rows if "fused_gram" in e.key)
    print(f"fused_gram kernel: {gram_us / 1e3:.3f} ms of {total / 1e3:.3f} ms device time "
          f"listed ({100 * gram_us / max(total, 1):.1f} %)")


if __name__ == "__main__":
    main()
