"""CLI: IMU-to-camera rotation + time-offset initialization.

Port of ``apps/estimate_imu_to_camera_rotation.py`` of the JAX package
(the reference binary ``estimate_imu_to_camera_rotation``), with the same
flags plus ``--device`` (default ``cuda``; without a CUDA device the run
raises unless ``--device cpu`` is given).

    python -m openimucameracalibrator_torch.apps.estimate_imu_to_camera_rotation \\
        --telemetry_json telemetry.json --input_pose_dataset poses.npz \\
        --imu_rotation_init_output init.json
"""

from __future__ import annotations

import argparse
import json


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--telemetry_json", required=True, help="generic telemetry json")
    p.add_argument("--input_pose_dataset", required=True, help="pose .npz or .calibdata")
    p.add_argument("--imu_rotation_init_output", required=True, help="output json")
    p.add_argument("--search_range_s", type=float, default=1.0)
    p.add_argument("--debug_dump", action="store_true",
                   help="store visual vs transformed-gyro angular velocities "
                        "in the output json (for misc_tools debug-calib)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs in float64)")
    return p


def run(args) -> str:
    from openimucameracalibrator_torch.apps.estimate_poses import load_pose_dataset
    from openimucameracalibrator_torch.core import imu_cam_rotation, telemetry
    from openimucameracalibrator_torch.utils import precision

    device = precision.resolve_device(args.device)
    tel = telemetry.read_generic_json(args.telemetry_json)
    poses = load_pose_dataset(args.input_pose_dataset)
    init = imu_cam_rotation.estimate_imu_to_camera_rotation(
        poses, tel.imu,
        imu_cam_rotation.RotationEstimatorOptions(search_range_s=args.search_range_s),
        device=device)
    out = {
        "gyro_to_camera_rotation": {k: float(v) for k, v in zip("wxyz", init.q_gyro_to_cam)},
        "time_offset_gyro_to_cam": init.time_offset,
        "gyro_bias": {k: float(v) for k, v in zip("xyz", init.gyro_bias)},
    }
    if args.debug_dump:
        out["debug_visual_ang_vel"] = init.debug_visual_ang_vel.tolist()
        out["debug_imu_ang_vel_transformed"] = init.debug_imu_ang_vel_transformed.tolist()
    with open(args.imu_rotation_init_output, "w") as f:
        json.dump(out, f, indent=1)
    print(f"time_offset={init.time_offset:+.4f}s -> {args.imu_rotation_init_output}")
    return args.imu_rotation_init_output


def load_imu_camera_init(path: str):
    import numpy as np

    from openimucameracalibrator_torch.utils.types import ImuCameraInit

    with open(path) as f:
        d = json.load(f)
    q = d["gyro_to_camera_rotation"]
    b = d["gyro_bias"]
    return ImuCameraInit(
        q_gyro_to_cam=np.asarray([q["w"], q["x"], q["y"], q["z"]]),
        time_offset=float(d["time_offset_gyro_to_cam"]),
        gyro_bias=np.asarray([b["x"], b["y"], b["z"]]))


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
