"""Where the port's pose estimation (stage 5) and rotation / time-offset
init (stage 7) spend their time on the GPU.

Renders the DS3-scale scene of chip_smoke.py on the card (3,598 views,
rolling shutter, true intrinsics), then prints:

* estimate_poses on all views, as a user calls it, under
  ``torch.profiler`` (after one warm call, which includes cuSOLVER's
  set-up): wall, peak device memory, device busy share and the top kernels;
  per step (the ``pose_estimator.*`` ranges of ``_estimate_all_poses``:
  undistortion, the RANSAC batch, the Gauss-Newton refinement, the final
  error) its host time and the device time of the kernels it launched; and
  the launches of kernels whose name holds "svd" or "jacobi" (cuSOLVER's
  batched SVD is a handful of launches per batch; a per-matrix loop is
  thousands);
* estimate_imu_to_camera_rotation: its wall and cost evaluations, and one
  cost evaluation under ``torch.profiler``.

Usage (needs one CUDA device): python scripts/profile_torch_pose_init.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from openimucameracalibrator_torch.core import imu_cam_rotation, pose_estimator  # noqa: E402
from openimucameracalibrator_torch.models import cameras  # noqa: E402
from openimucameracalibrator_torch.utils import precision, synthetic  # noqa: E402
from openimucameracalibrator_torch.utils.types import (CameraCalibration, CornerDataset,  # noqa: E402
                                                       ImuData)
from profile_torch_intrinsics import _is_range, profiled, timed  # noqa: E402


def main():
    dev = precision.resolve_device("cuda")
    print(f"{torch.cuda.get_device_name(0)}; {cs.smi_line()}")
    scene = synthetic.make_imu_camera_scene(
        cameras.get_model("division_undistortion"), cs.CAM, duration=cs.DURATION,
        cam_fps=cs.CAM_FPS, imu_rate=cs.IMU_RATE, image_size=(960, 540), noise_px=0.2,
        time_offset=cs.TIME_OFFSET, line_delay=cs.LINE_DELAY, seed=7, device=dev)
    ds = CornerDataset(scene.frame_times, scene.observations, scene.obs_valid,
                       np.asarray(scene.board.points), scene.image_size, cs.CAM_FPS)
    calib = CameraCalibration("division_undistortion", np.asarray(cs.CAM), scene.image_size, 0.0)
    V = ds.valid.shape[0]

    pose_estimator.estimate_poses(ds, calib, device=dev)  # warm: cuSOLVER's set-up
    torch.cuda.reset_peak_memory_stats()
    out = {}
    prof = profiled(lambda: out.update(poses=pose_estimator.estimate_poses(ds, calib,
                                                                           device=dev)),
                    f"estimate_poses on {V} views")
    poses = out["poses"]
    print(f"estimate_poses on {V} views: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {int(poses.valid.sum())} valid")
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    steps = [e for e in prof.events()
             if e.device_type == cpu and e.name.startswith("pose_estimator.")]
    print("estimate_poses by step (host ms / device ms of its kernels): " + "; ".join(
        f"{e.name[len('pose_estimator.'):]} {e.cpu_time_total / 1e3:.1f} / "
        f"{e.device_time_total / 1e3:.1f}" for e in steps))
    svd = [e for e in prof.events() if e.device_type == cuda and not _is_range(e)
           and ("svd" in e.name.lower() or "jacobi" in e.name.lower())]
    print(f"estimate_poses on {V} views: {len(svd)} launches of SVD kernels "
          f"({sorted({e.name[:60] for e in svd})})")

    imu = ImuData(scene.imu_times, scene.accel, scene.gyro)
    n_cost = [0]
    real = imu_cam_rotation._alignment_cost

    def counting(*args):
        n_cost[0] += 1
        return real(*args)

    imu_cam_rotation._alignment_cost = counting
    try:
        init, ms = timed(lambda: imu_cam_rotation.estimate_imu_to_camera_rotation(
            poses, imu, device=dev))
    finally:
        imu_cam_rotation._alignment_cost = real
    print(f"estimate_imu_to_camera_rotation: {ms:.1f} ms, {n_cost[0]} cost evaluations "
          f"({ms / n_cost[0]:.3f} ms each), time offset {init.time_offset:+.6f} s")
    # One cost evaluation, as the search makes it (inputs on the device).
    dt = precision.default_dtype(dev)
    t = torch.as_tensor(imu.times - imu.times[0], dtype=dt, device=dev)
    g = torch.as_tensor(imu.gyro, dtype=dt, device=dev)
    keep = torch.ones_like(t)
    profiled(lambda: float(imu_cam_rotation._alignment_cost(
        torch.tensor(0.01, dtype=dt, device=dev), t, g, t, g, keep)[0]), "one cost evaluation")


if __name__ == "__main__":
    main()
