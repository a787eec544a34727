"""CLI: joint calibration of ONE rig from MANY recordings.

Port of ``apps/batch_calibration.py`` of the JAX package, with the same
flags plus ``--device`` (default ``cuda``; without a CUDA device the run
raises unless ``--device cpu`` is given). N (video, telemetry) pairs run
their per-recording front-end stages (charuco / radon / apriltag corner
extraction through ``board_extractor.extract_board_from_video``, pose
estimation, SEW, gyro-alignment init) and then ONE batched
continuous-time solve (``core/batch_estimator.py``):

* ``--mode joint`` (default): T_imu_cam, rolling-shutter line delay and
  IMU intrinsics are SHARED across recordings (arrowhead Schur solve);
  trajectories, biases, gravity and each recording's clock offset stay
  per-sequence.
* ``--mode independent``: N separate solutions from one batched solve.

The spline knot spacings must be common across sequences; the CLI
takes the MINIMUM SEW spacing over recordings. Decoding the videos needs
cv2.

    python -m openimucameracalibrator_torch.apps.batch_calibration \\
        --recording v1.MP4 --recording v2.MP4 --recording v3.MP4 \\
        --camera_calibration_json cam_calib.json \\
        --telemetry_format gopro --output_json rig_result.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--recording", action="append", required=True,
                   help="imu-cam MP4 (repeat once per recording); for "
                        "--telemetry_format gopro the GPMF telemetry is "
                        "extracted from the MP4 itself, otherwise pass "
                        "--telemetry per recording in the same order")
    p.add_argument("--telemetry", action="append", default=[],
                   help="telemetry file per recording (same order)")
    p.add_argument("--telemetry_format", default="gopro",
                   choices=["generic", "gopro", "pygpmf", "zed", "csv"])
    p.add_argument("--camera_calibration_json", required=True,
                   help="intrinsics from apps.calibrate_camera / stage 1")
    p.add_argument("--mode", default="joint", choices=["joint", "independent"])
    p.add_argument("--board_type", default="charuco")
    p.add_argument("--num_squares_x", type=int, default=10)
    p.add_argument("--num_squares_y", type=int, default=8)
    p.add_argument("--checker_size_m", type=float, default=0.04)
    p.add_argument("--marker_size_m", type=float, default=0.0)
    p.add_argument("--global_shutter", action="store_true")
    p.add_argument("--max_iters", type=int, default=50)
    p.add_argument("--output_json", default="batch_calibration_result.json")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs in float64)")
    return p


def _telemetry(args, i, video):
    from openimucameracalibrator_torch.core import telemetry

    if args.telemetry_format == "gopro" and not args.telemetry:
        return telemetry.read_gopro_mp4(video)
    if args.telemetry_format == "generic":
        return telemetry.read_generic_json(args.telemetry[i])
    return telemetry.read_gopro_telemetry(args.telemetry[i])


def run(args) -> dict:
    import torch

    from openimucameracalibrator_torch.core import (batch_estimator as be, board_extractor,
                                                    imu_cam_rotation, pose_estimator,
                                                    spline_estimator as se)
    from openimucameracalibrator_torch.ops import lie
    from openimucameracalibrator_torch.ops import sew as sew_mod
    from openimucameracalibrator_torch.solver import lm
    from openimucameracalibrator_torch.utils import io, precision

    device = precision.resolve_device(args.device)
    dtype = precision.default_dtype(device)
    calib = io.load_camera_calibration(args.camera_calibration_json)
    opts = board_extractor.BoardExtractorOptions(
        board_type=args.board_type, squares_x=args.num_squares_x,
        squares_y=args.num_squares_y, square_length=args.checker_size_m,
        marker_length=args.marker_size_m or 0.75 * args.checker_size_m)

    fronts = []
    for i, video in enumerate(args.recording):
        print(f"--- recording {i}: {video}")
        tel = _telemetry(args, i, video)
        corners = board_extractor.extract_board_from_video(video, opts, device=device)
        print(f"   {int(np.asarray(corners.valid).sum())} corners over "
              f"{corners.num_views} views")
        poses = pose_estimator.estimate_poses(corners, calib, device=device)
        print(f"   {int(poses.valid.sum())}/{len(poses.times)} poses")
        if int(poses.valid.sum()) < 10:
            raise RuntimeError(
                f"recording {i} ({video}): only {int(poses.valid.sum())} valid poses; "
                "check the board geometry flags and the camera calibration")
        sew = sew_mod.compute_sew(tel.imu, corners.fps or 30.0)
        init = imu_cam_rotation.estimate_imu_to_camera_rotation(poses, tel.imu, device=device)
        print(f"   time offset {init.time_offset:+.4f}s "
              f"dt_so3={sew.dt_so3:.3f} dt_r3={sew.dt_r3:.3f}")
        fronts.append((corners, poses, tel, sew, init))

    # Common knot spacings: the minimum over recordings.
    dt_so3 = min(f[3].dt_so3 for f in fronts)
    dt_r3 = min(f[3].dt_r3 for f in fronts)
    problems, inits = [], []
    rolling_shutter = not args.global_shutter
    for corners, poses, tel, sew, init in fronts:
        sew_c = dataclasses.replace(sew, dt_so3=dt_so3, dt_r3=dt_r3)
        # The spline stage sees only pose-validated views.
        corners = dataclasses.replace(
            corners, valid=np.asarray(corners.valid) & np.asarray(poses.valid)[:, None])
        p = se.build_problem(corners, calib, tel.imu, sew_c, init.time_offset,
                             rolling_shutter, dtype=dtype, device=device)
        q_i_c0 = lie.quat_conjugate(torch.as_tensor(np.asarray(init.q_gyro_to_cam),
                                                    dtype=dtype)).numpy()
        prm = se.init_spline_params(poses, q_i_c0, np.zeros(3), p, tel.imu,
                                    pose_time_offset=init.time_offset, dtype=dtype,
                                    device=device)
        prm["bias_g"] = torch.as_tensor(np.asarray(init.gyro_bias), dtype=dtype,
                                        device=device).expand_as(prm["bias_g"]).clone()
        if rolling_shutter:
            h = corners.image_size[1]
            prm["line_delay"] = torch.tensor([1.0 / (sew.cam_fps or 30.0) / h], dtype=dtype,
                                             device=device)
        problems.append(p)
        inits.append(prm)

    flags = se.DEFAULT_FLAGS | ({se.CAM_LINE_DELAY, se.TIME_OFFSET} if rolling_shutter
                                else {se.TIME_OFFSET})
    print(f"--- batched solve: {len(problems)} sequences, mode={args.mode}")
    res = be.optimize_batch(problems, inits, flags=flags,
                            config=lm.LMConfig(max_iters=args.max_iters, ftol=1e-4),
                            mode=args.mode)

    def L(x):
        return x.detach().cpu().numpy().astype(np.float64).tolist()

    out = {"mode": args.mode, "n_sequences": len(problems),
           "dt_so3": dt_so3, "dt_r3": dt_r3, "sequences": []}
    if args.mode == "joint":
        prm0 = res.params[0]
        out["q_i_c"] = L(prm0["q_i_c"])
        out["t_i_c"] = L(prm0["t_i_c"])
        out["line_delay_us"] = float(prm0["line_delay"][0]) * 1e6
        out["final_cost"] = float(res.cost)
    for i, (p, prm) in enumerate(zip(problems, res.params)):
        seq = {"recording": args.recording[i],
               "mean_reproj_error_px": float(se.mean_reprojection_error(p, prm)),
               "time_offset_s": float(fronts[i][4].time_offset + float(prm["time_offset"][0])),
               "gravity": L(prm["gravity"])}
        if args.mode == "independent":
            seq["q_i_c"] = L(prm["q_i_c"])
            seq["t_i_c"] = L(prm["t_i_c"])
            seq["line_delay_us"] = float(prm["line_delay"][0]) * 1e6
            seq["cost"] = float(res.cost[i])
            seq["iterations"] = int(res.iterations[i])
        out["sequences"].append(seq)
    print(json.dumps(out, indent=1))
    with open(args.output_json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.output_json}")
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
