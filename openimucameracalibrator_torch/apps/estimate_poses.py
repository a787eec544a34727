"""CLI: per-frame pose estimation with fixed intrinsics.

Port of ``apps/estimate_poses.py`` of the JAX package (the reference
binary ``estimate_camera_poses_from_checkerboard``), with the same flags
plus ``--device`` (default ``cuda``; without a CUDA device the run raises
unless ``--device cpu`` is given). Poses are written as an npz artifact,
or, when the output path ends in ``.calibdata``, as the reference's
Theia-binary pose dataset (``utils/theia_io.py``).

    python -m openimucameracalibrator_torch.apps.estimate_poses \\
        --input_corners corners.uson --camera_calibration_json calib.json \\
        --output_pose_dataset poses.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_corners", required=True)
    p.add_argument("--camera_calibration_json", required=True)
    p.add_argument("--output_pose_dataset", required=True,
                   help="output .npz (native) or .calibdata (Theia binary)")
    p.add_argument("--optimize_board_points", action="store_true",
                   help="accepted as by the JAX CLI, which does not apply it either; "
                        "run_calibration applies it")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs in float64)")
    return p


def run(args) -> str:
    from openimucameracalibrator_torch.core import pose_estimator
    from openimucameracalibrator_torch.utils import io, precision

    if args.optimize_board_points:
        print("estimate_poses: --optimize_board_points is not applied here (nor by the JAX "
              "CLI); run_calibration --optimize_board_points refines the board points",
              file=sys.stderr)
    device = precision.resolve_device(args.device)
    ds = io.load_corners(args.input_corners)
    calib = io.load_camera_calibration(args.camera_calibration_json)
    poses = pose_estimator.estimate_poses(ds, calib, device=device)
    if args.output_pose_dataset.endswith(".calibdata"):
        # Theia-binary pose dataset, the reference artifact
        # (estimate_camera_poses_from_checkerboard.cc:71).
        from openimucameracalibrator_torch.utils import theia_io
        theia_io.save_pose_dataset_calibdata(args.output_pose_dataset, poses, calib)
    else:
        np.savez(args.output_pose_dataset, times=poses.times, q_w_c=poses.q_w_c,
                 t_w_c=poses.t_w_c, valid=poses.valid, board_points=poses.board_points)
    print(f"{int(poses.valid.sum())}/{len(poses.times)} poses -> {args.output_pose_dataset}")
    return args.output_pose_dataset


def load_pose_dataset(path: str):
    """PoseDataset from a ``.npz`` or a Theia ``.calibdata`` file."""
    from openimucameracalibrator_torch.utils.types import PoseDataset

    if path.endswith(".calibdata"):
        from openimucameracalibrator_torch.utils import theia_io
        poses, _, _ = theia_io.load_pose_dataset_calibdata(path)
        return poses
    z = np.load(path)
    return PoseDataset(times=z["times"], q_w_c=z["q_w_c"], t_w_c=z["t_w_c"],
                       valid=z["valid"], board_points=z["board_points"])


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
