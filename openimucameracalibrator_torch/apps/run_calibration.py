"""CLI: the full 9-step calibration pipeline in one process.

Port of ``apps/run_calibration.py`` of the JAX package (the reference's
master scripts, python/run_gopro_calibration.py:137-333 and its
smartphone / ZED / MYNT-EYE variants), with the same flags plus
``--device`` (default ``cuda``; without a CUDA device the run raises
unless ``--device cpu`` is given; the CPU runs in float64, the card in
float32). Each stage is a library call and artifacts are kept in memory
(persisted to ``--workspace`` when given).

Steps (run_gopro_calibration.py numbering):
  0. corner extraction (cam video + cam-imu video)
  1. intrinsic calibration
  2/3. telemetry import -> generic json
  4. static bias estimation
  5. per-frame pose estimation
  6. spline error weighting
  7. IMU-to-camera rotation + time offset init
  8. continuous-time batch calibration
  9. result summary

Camera-clock anchoring: when the telemetry carries per-frame timestamps,
the imu-cam corner dataset is re-stamped with them so frame times and IMU
times share one clock before the offset search. For a GoPro MP4
(``--telemetry_format gopro``, read by the native GPMF reader of
``core/gpmf.py``) these are the video track's frame times, or the CORI
stream's when it has one sample per frame.

With ``--workspace``, corner files found there are used instead of
detecting again (``--recompute_corners`` forces detection), as the
reference's extract_board_to_json.cc:60-64 does. Every board of the JAX
CLI (charuco by default, radon, apriltag) goes through the native
detectors of ``core/board_extractor.py``. Decoding a video needs cv2, and
the run says so without it; a workspace seeded with ``cam_corners.uson``
and ``imu_cam_corners.uson`` (``utils/io.save_corners`` of what
``board_extractor.extract_board`` found on in-memory (time, gray) frames)
runs without it. The OpenCV detection backend needs cv2 too.

The multi-process flags (``--coordinator_address``, ``--num_processes``,
``--process_id``) join a ``torch.distributed`` group and print the rank and
world size, as the JAX CLI does; the run itself is the same.

    python -m openimucameracalibrator_torch.apps.run_calibration \\
        --path_calib_dataset data --telemetry_json data/telemetry.json \\
        --workspace ws
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--path_calib_dataset", required=True,
                   help="directory with cam video, imu-cam video, telemetry")
    p.add_argument("--cam_video", default="", help="intrinsics video (default: cam.MP4)")
    p.add_argument("--imu_cam_video", default="", help="imu-cam video")
    p.add_argument("--telemetry_json", required=True,
                   help="telemetry file (format per --telemetry_format); for "
                        "'pilotguru' a directory with accelerations.json / "
                        "rotations.json / frames.json")
    p.add_argument("--telemetry_format", default="generic",
                   choices=["generic", "gopro", "pygpmf", "zed", "csv", "pilotguru"])
    p.add_argument("--camera_model", default="DIVISION_UNDISTORTION")
    p.add_argument("--board_type", default="charuco")
    p.add_argument("--checker_size_m", type=float, default=0.04)
    p.add_argument("--marker_size_m", type=float, default=0.0,
                   help="aruco marker side (default 0.75 * checker size)")
    p.add_argument("--num_squares_x", type=int, default=10)
    p.add_argument("--num_squares_y", type=int, default=8)
    p.add_argument("--voxel_grid_size", type=float, default=0.04)
    p.add_argument("--global_shutter", action="store_true")
    p.add_argument("--detector_kernel", default="auto", choices=["auto", "xla", "pallas"],
                   help="only 'auto': a CUDA frame always takes the hand-written corner "
                        "kernel, a CPU frame its plain version")
    p.add_argument("--detector_backend", default="native", choices=["native", "opencv"])
    p.add_argument("--aruco_detector_params", default="",
                   help="detector-parameter file, OpenCV-YAML or json (see detect/params.py)")
    p.add_argument("--optimize_board_points", action="store_true",
                   help="refine board points w/ empirical covariance "
                        "(reference OptimizeBoardPoints, pose_estimator.cc:193-224)")
    p.add_argument("--workspace", default="", help="persist stage artifacts here")
    p.add_argument("--recompute_corners", action="store_true")
    p.add_argument("--imu_intrinsics_json", default="",
                   help="static multi-pose IMU intrinsics json (read_misc.cc:84-150)")
    # Multi-process launch (parallel/multihost.py).
    p.add_argument("--coordinator_address", default="",
                   help="host:port of process 0 for torch.distributed")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs in float64)")
    return p


def _read_telemetry(path, fmt):
    from openimucameracalibrator_torch.core import telemetry

    if fmt == "gopro" and path.lower().endswith(".mp4"):
        return telemetry.read_gopro_mp4(path)
    if fmt == "pilotguru":
        d = path if os.path.isdir(path) else os.path.dirname(path)
        return telemetry.read_pilotguru(
            os.path.join(d, "accelerations.json"),
            os.path.join(d, "rotations.json"),
            os.path.join(d, "frames.json"))
    readers = {"generic": telemetry.read_generic_json,
               "gopro": telemetry.read_gopro_telemetry,
               "pygpmf": telemetry.read_pygpmf_json,
               "zed": telemetry.read_zed_jsonl,
               "csv": telemetry.read_generic_csv}
    return readers[fmt](path)


def _extract_corners(video, opts, ws_path, recompute, device):
    """Corner extraction with workspace skip-if-exists
    (extract_board_to_json.cc:60-64)."""
    from openimucameracalibrator_torch.core import board_extractor
    from openimucameracalibrator_torch.utils import io

    if ws_path and os.path.exists(ws_path) and not recompute:
        print(f"   (cached: {ws_path})")
        return io.load_corners(ws_path)
    ds = board_extractor.extract_board_from_video(video, opts, device=device)
    if ws_path:
        io.save_corners(ds, ws_path)
    return ds


def run(args) -> dict:
    from openimucameracalibrator_torch.apps.continuous_time_calibration import \
        maybe_init_distributed

    maybe_init_distributed(args)
    if args.detector_kernel != "auto":
        raise ValueError(
            f"--detector_kernel {args.detector_kernel}: the port has one corner-response "
            "route per device (a CUDA frame takes the hand-written kernel, a CPU frame "
            "its plain version); only 'auto' is accepted")

    from openimucameracalibrator_torch.core import (board_extractor, camera_calibrator,
                                                    imu_cam_rotation, imu_camera_calibrator,
                                                    pose_estimator)
    from openimucameracalibrator_torch.ops import sew as sew_mod
    from openimucameracalibrator_torch.utils import io, precision

    device = precision.resolve_device(args.device)
    ws = args.workspace
    if ws:
        os.makedirs(ws, exist_ok=True)
    timings = {}
    t_last = [time.perf_counter()]
    cur = [None]

    def stage(name):
        now = time.perf_counter()
        if cur[0] is not None:
            timings[cur[0]] = round(now - t_last[0], 3)
        cur[0], t_last[0] = name, now
        print(f"--- {name} ({time.strftime('%H:%M:%S')})")

    opts = board_extractor.BoardExtractorOptions(
        board_type=args.board_type, squares_x=args.num_squares_x,
        squares_y=args.num_squares_y, square_length=args.checker_size_m,
        marker_length=args.marker_size_m or 0.75 * args.checker_size_m,
        backend=args.detector_backend, detector_params_path=args.aruco_detector_params)

    stage("2/3. telemetry import")
    tel = _read_telemetry(args.telemetry_json, args.telemetry_format)

    stage("0a. corner extraction: intrinsics video")
    cam_video = args.cam_video or os.path.join(args.path_calib_dataset, "cam.MP4")
    corners_cam = _extract_corners(cam_video, opts, ws and os.path.join(ws, "cam_corners.uson"),
                                   args.recompute_corners, device)

    stage("0b. corner extraction: imu-cam video")
    imu_video = args.imu_cam_video or os.path.join(args.path_calib_dataset, "imu_cam.MP4")
    corners_imucam = _extract_corners(imu_video, opts,
                                      ws and os.path.join(ws, "imu_cam_corners.uson"),
                                      args.recompute_corners, device)

    # Camera-clock anchoring: prefer the telemetry's per-frame timestamps
    # (GPMF video track / CORI t0, estimate_imu_to_camera_rotation.cc:85-99).
    if tel.img_times is not None and len(tel.img_times) >= len(corners_imucam.times):
        img_t = np.asarray(tel.img_times[:len(corners_imucam.times)], np.float64)
        corners_imucam = dataclasses.replace(corners_imucam, times=img_t)
        print(f"   frame times anchored to telemetry clock (t0={img_t[0]:.4f}s)")

    stage("1. intrinsic calibration")
    calib, calib_details = camera_calibrator.calibrate_camera(
        corners_cam, args.camera_model,
        camera_calibrator.CameraCalibratorOptions(grid_size=args.voxel_grid_size),
        device=device)
    print(f"   reproj error: {calib.mean_reproj_error:.4f}px")
    if ws:
        io.save_camera_calibration(calib, os.path.join(ws, "cam_calib.json"))

    stage("4. static bias estimation")
    accel_bias, gyro_bias, bias_source = sew_mod.estimate_static_biases(tel.imu)
    if bias_source == "none":
        print("   no static interval; starting batch stage from zero biases")

    stage("5. pose estimation")
    poses = pose_estimator.estimate_poses(corners_imucam, calib, device=device)
    print(f"   {int(poses.valid.sum())}/{len(poses.times)} poses")
    if args.optimize_board_points:
        poses, pt_info = pose_estimator.optimize_board_points(corners_imucam, calib, poses,
                                                              device=device)
        # The batch stage sees the refined board geometry (the reference
        # rebuilds its tracks from the optimized board points,
        # continuous_time_imu_to_camera_calibration.cc:109-161).
        corners_imucam = dataclasses.replace(
            corners_imucam, board_points=np.asarray(poses.board_points))
    else:
        pt_info = None

    stage("6. spline error weighting")
    sew = sew_mod.compute_sew(tel.imu, corners_imucam.fps or 30.0)
    print(f"   dt_so3={sew.dt_so3:.3f}s dt_r3={sew.dt_r3:.3f}s")

    stage("7. IMU-camera rotation + time offset")
    init = imu_cam_rotation.estimate_imu_to_camera_rotation(poses, tel.imu, device=device)
    print(f"   time offset {init.time_offset:+.4f}s")

    stage("8. continuous-time batch calibration")
    imu_intr = None
    if args.imu_intrinsics_json:
        imu_intr = io.load_imu_intrinsics(args.imu_intrinsics_json)
    result = imu_camera_calibrator.calibrate_imu_camera(
        corners_imucam, calib, poses, tel.imu, init, sew,
        rolling_shutter=not args.global_shutter,
        accel_bias0=accel_bias, gyro_bias0=gyro_bias,
        accl_intrinsics=imu_intr[0] if imu_intr else None,
        gyro_intrinsics=imu_intr[1] if imu_intr else None,
        # POINTS block + feature-covariance whitening seeded by the
        # empirical covariances of stage 5 (pose_estimator.cc:193-224).
        optimize_board_points=args.optimize_board_points,
        board_point_cov=pt_info["point_cov"] if pt_info else None,
        reproj_cov=pt_info["reproj_cov"] if pt_info else None,
        # Solver-state checkpoints live next to the stage artifacts, so an
        # interrupted batch stage resumes mid-schedule.
        checkpoint_dir=os.path.join(ws, "solver_ckpt") if ws else None,
        device=device)
    if ws:
        io.save_imu_camera_result(result, os.path.join(ws, "imu_cam_result.json"))

    stage("9. summary")
    timings[cur[0]] = 0.0
    summary = {
        "intrinsics_reproj_error_px": calib.mean_reproj_error,
        "intrinsics_params": np.asarray(calib.params).tolist(),
        "camera_model": calib.model_name,
        "final_reproj_error_px": result.mean_reproj_error,
        "time_offset_s": result.time_offset,
        "line_delay_us": result.line_delay * 1e6,
        "q_i_c": result.q_i_c.tolist(),
        "t_i_c": result.t_i_c.tolist(),
        "gravity": result.gravity.tolist(),
        # "none" = no static interval; the batch stage started from zero
        # biases (downstream consumers can tell from this marker).
        "bias_estimate": bias_source,
        "stage_timings_s": timings,
        # Stage 1's LM solves (the double sphere's multi-start among them)
        # and its initialization seconds (core/camera_calibrator).
        "intrinsics_solves": calib_details["lm_stages"],
        "intrinsics_init_s": calib_details["init_seconds"],
    }
    print(json.dumps(summary, indent=1))
    if ws:
        with open(os.path.join(ws, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
