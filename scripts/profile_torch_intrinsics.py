"""Where the port's radon intrinsics path spends its time on the GPU.

Renders the 300-frame 960x540 checkerboard sweep of chip_smoke.py on the
card, detects the board in every frame, then prints:

* detection of 20 frames under ``torch.profiler``: wall, device busy
  share, kernel launches per frame and device time by kernel, top 15;
* the calibration's initialization on the 300 views, by step (host clock
  around work that ends in a device sync): the 26-lambda division search,
  the homographies of the undistorted corners, Zhang's focal, the poses;
* the whole initialization's time, and one batch of 300 homographies (a
  27th of it) under ``torch.profiler``: wall, device busy share, launches
  and device time by kernel, top 15.

Usage (needs one CUDA device): python scripts/profile_torch_intrinsics.py
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from openimucameracalibrator_torch.core import board_extractor, camera_calibrator  # noqa: E402
from openimucameracalibrator_torch.detect import checkerboard, render  # noqa: E402
from openimucameracalibrator_torch.ops import pnp  # noqa: E402
from openimucameracalibrator_torch.utils import precision, recorded, synthetic  # noqa: E402


def _is_range(e):
    """A ``record_function`` range's span on the device timeline, not a
    kernel."""
    return bool(getattr(e, "is_user_annotation", False)) or e.key.startswith("pose_estimator.")


def profiled(fn, label):
    """Run fn() under torch.profiler; print wall, busy share, top kernels;
    return the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted((e for e in prof.key_averages() if e.device_type == cuda and not _is_range(e)),
                  key=lambda e: -e.self_device_time_total)
    kernels = [e for e in prof.events() if e.device_type == cuda and not _is_range(e)]
    busy_us = sum(e.device_time for e in kernels)
    if not rows:
        print(f"{label}: the profiler recorded no device time")
    print(f"{label}: wall {wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / 1e3 / (wall * 1e3):.1f} %), {len(kernels)} kernel launches")
    print(f"{'device ms':>10} {'calls':>6}  name")
    for e in rows[:15]:
        print(f"{e.self_device_time_total / 1e3:10.3f} {e.count:6d}  {e.key[:100]}")
    return prof


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def main():
    dev = precision.resolve_device("cuda")
    print(f"{torch.cuda.get_device_name(0)}; {cs.smi_line()}")
    times, frames = cs.render_phase(torch, recorded, render, synthetic, dev)
    opts = board_extractor.BoardExtractorOptions(board_type="radon", squares_x=cs.SQUARES[0],
                                                 squares_y=cs.SQUARES[1])
    ds = board_extractor.extract_board(zip(times, frames), opts, fps=30.0, device=dev)
    print(f"{int(ds.valid.all(-1).sum())} of {len(frames)} frames with the full grid")

    def detect20():
        for f in frames[:20]:
            checkerboard.detect_checkerboard(f, *cs.SQUARES, device=dev)

    profiled(detect20, "detection of 20 frames")

    # The initialization, step by step, as camera_calibrator.initialize_views runs it.
    dt = torch.float32
    w, h = ds.image_size
    cc = torch.tensor([w / 2.0, h / 2.0], dtype=dt, device=dev)
    obs = torch.as_tensor(ds.points2d, dtype=dt, device=dev)
    mask = torch.as_tensor(ds.valid, device=dev).to(dt)
    obj = torch.as_tensor(ds.board_points[:, :2], dtype=dt, device=dev).expand(
        obs.shape[:1] + (-1, -1))
    lam_grid = torch.as_tensor(np.linspace(-2.0, 0.5, 26) / (w * w + h * h), dtype=dt, device=dev)
    steps = {}
    for _ in range(2):  # the first pass includes cuSOLVER's set-up
        (lam, _, _), steps["division search (26 x 300 homographies)"] = timed(
            lambda: pnp.radial_division_init(obj, obs - cc, mask, lam_grid))
        r2 = torch.sum((obs - cc) ** 2, -1)
        und = (obs - cc) / (1.0 + lam * r2)[..., None]
        Hs, steps["homographies (300)"] = timed(lambda: pnp.homography_dlt(obj, und, mask))
        enough = torch.as_tensor(ds.valid.sum(-1) >= 10, device=dev)
        f0, steps["Zhang focal"] = timed(lambda: pnp.zhang_focal(Hs, enough))
        zero = torch.zeros((len(Hs), 2), dtype=dt, device=dev)
        _, steps["poses (300)"] = timed(lambda: pnp.pose_from_homography(
            Hs, f0.expand(len(Hs)), zero))
    print("initialization by step (second pass, ms): " + "; ".join(
        f"{k} {v:.1f}" for k, v in steps.items()))
    _, init_ms = timed(lambda: camera_calibrator.initialize_views(ds, distortion_aware=True,
                                                                  device=dev))
    print(f"initialize_views on {len(frames)} views: {init_ms:.1f} ms")
    # One batch of homographies under the profiler (the whole initialization
    # is ~27 such batches; profiling all of it takes minutes to post-process).
    profiled(lambda: pnp.homography_dlt(obj, und, mask), f"{len(frames)} homographies")


if __name__ == "__main__":
    main()
