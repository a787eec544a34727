"""CLI: full continuous-time IMU-camera batch calibration (stage 8).

Port of ``apps/continuous_time_calibration.py`` of the JAX package, with
the same flags plus ``--device`` (default ``cuda``; without a CUDA device
the run raises unless ``--device cpu`` is given).

    python -m openimucameracalibrator_torch.apps.continuous_time_calibration \\
        --input_corners corners.uson --camera_calibration_json calib.json \\
        --input_pose_dataset poses.npz --telemetry_json telemetry.json \\
        --imu_rotation_init init.json --spline_weighting_json sew.json \\
        --output_path result.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_corners", required=True)
    p.add_argument("--camera_calibration_json", required=True)
    p.add_argument("--input_pose_dataset", required=True)
    p.add_argument("--telemetry_json", required=True)
    p.add_argument("--imu_rotation_init", required=True)
    p.add_argument("--spline_weighting_json", required=True)
    p.add_argument("--imu_bias_json", default="")
    p.add_argument("--imu_intrinsics_json", default="",
                   help="static multi-pose IMU intrinsics json")
    p.add_argument("--optimize_imu_intrinsics", action="store_true")
    p.add_argument("--output_path", required=True)
    p.add_argument("--global_shutter", action="store_true")
    p.add_argument("--max_iters", type=int, default=50)
    p.add_argument("--line_delay_iters", type=int, default=10)
    p.add_argument("--no_time_offset_refinement", action="store_true",
                   help="reference-parity mode: freeze the init offset")
    p.add_argument("--profile_trace_dir", default="",
                   help="write a torch.profiler (Chrome) trace of the batch "
                        "optimization to this directory")
    p.add_argument("--solver_checkpoint_dir", default="",
                   help="snapshot the solution after every LM stage and "
                        "resume from completed stages on rerun")
    # Multi-process launch (parallel/multihost.py): pass the coordinator to
    # join a torch.distributed group; single-process runs leave these unset.
    p.add_argument("--coordinator_address", default="",
                   help="host:port of process 0 for torch.distributed")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs in float64)")
    return p


def maybe_init_distributed(args) -> bool:
    """Join a multi-process group when asked (no-op on one process) and
    print this process's rank and the world size."""
    from openimucameracalibrator_torch.parallel import multihost

    joined = multihost.initialize(
        coordinator_address=getattr(args, "coordinator_address", "") or None,
        num_processes=getattr(args, "num_processes", 0) or None,
        process_id=(args.process_id if getattr(args, "process_id", -1) >= 0 else None),
        device=args.device)
    if joined:
        import torch.distributed as dist

        print(f"torch.distributed: process {multihost.process_index()}/"
              f"{multihost.process_count()}, backend {dist.get_backend()}, device "
              f"{multihost.global_mesh().device}")
    return joined


def _profile(trace_dir: str, device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)

    @contextlib.contextmanager
    def ctx():
        with prof:
            yield
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "continuous_time_calibration.json"))

    return ctx()


def run(args) -> str:
    import numpy as np

    maybe_init_distributed(args)

    from openimucameracalibrator_torch.apps.estimate_imu_to_camera_rotation import \
        load_imu_camera_init
    from openimucameracalibrator_torch.apps.estimate_poses import load_pose_dataset
    from openimucameracalibrator_torch.core import imu_camera_calibrator, telemetry
    from openimucameracalibrator_torch.utils import io, precision
    from openimucameracalibrator_torch.utils.types import SplineWeightingData

    device = precision.resolve_device(args.device)
    corners = io.load_corners(args.input_corners)
    calib = io.load_camera_calibration(args.camera_calibration_json)
    poses = load_pose_dataset(args.input_pose_dataset)
    tel = telemetry.read_generic_json(args.telemetry_json)
    init = load_imu_camera_init(args.imu_rotation_init)
    with open(args.spline_weighting_json) as f:
        sw = json.load(f)
    sew = SplineWeightingData(
        dt_so3=sw["so3"]["knot_spacing"], dt_r3=sw["r3"]["knot_spacing"],
        std_so3=sw["so3"]["weighting_factor"], std_r3=sw["r3"]["weighting_factor"],
        cam_fps=sw.get("camera_fps", 30.0))
    accel_bias0 = gyro_bias0 = None
    if args.imu_bias_json:
        with open(args.imu_bias_json) as f:
            b = json.load(f)
        accel_bias0 = np.asarray([b["accl_bias"][k] for k in "xyz"])
        gyro_bias0 = np.asarray([b["gyro_bias"][k] for k in "xyz"])

    accl_intr = gyro_intr = None
    if args.imu_intrinsics_json:
        accl_intr, gyro_intr = io.load_imu_intrinsics(args.imu_intrinsics_json)

    trace_ctx = (_profile(args.profile_trace_dir, device) if args.profile_trace_dir
                 else contextlib.nullcontext())
    with trace_ctx:
        result = imu_camera_calibrator.calibrate_imu_camera(
            corners, calib, poses, tel.imu, init, sew,
            rolling_shutter=not args.global_shutter,
            accel_bias0=accel_bias0, gyro_bias0=gyro_bias0,
            accl_intrinsics=accl_intr, gyro_intrinsics=gyro_intr,
            optimize_imu_intrinsics=args.optimize_imu_intrinsics,
            refine_time_offset=not args.no_time_offset_refinement,
            max_iters=args.max_iters, line_delay_iters=args.line_delay_iters,
            checkpoint_dir=args.solver_checkpoint_dir or None,
            device=device)
    io.save_imu_camera_result(result, args.output_path)
    print(f"final reproj error: {result.mean_reproj_error:.4f}px, "
          f"time offset {result.time_offset:+.4f}s, "
          f"line delay {result.line_delay * 1e6:.2f}us -> {args.output_path}")
    return args.output_path


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
