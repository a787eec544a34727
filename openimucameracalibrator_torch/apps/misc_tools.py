"""CLI: the small pipeline tools.

Port of ``apps/misc_tools.py`` of the JAX package:

* ``sew_main`` — spline error weighting (reference
  python/get_sew_for_dataset.py:38-56)
* ``biases_main`` — static bias estimate (python/get_imu_biases.py:39-62)
* ``static_imu_main`` — multi-pose IMU intrinsics
  (applications/static_imu_calibration.cc:38-88); writes the json that
  ``utils/io.load_imu_intrinsics`` reads (``run_calibration
  --imu_intrinsics_json``)
* ``allan_main`` — IMU noise characterization
  (applications/fit_allan_variance.cc:32-45)
* ``board_main`` — printable charuco board PNG (create_charuco_board.cc,
  the native renderer; PIL writes the PNG)
* ``extract_frames_main`` — video frames to a PNG folder (needs cv2 to
  decode, and says so without it)
* ``debug_calib_main`` — visual vs gyro angular-velocity plot
  (python/debug_calib.py)
* ``result_stats_main`` — spline-vs-IMU plots from a result json
  (python/print_result_stats.py:24-95)

The two fits (static IMU, Allan) run their LM solves on ``--device``
(default ``cuda``; without a CUDA device they raise unless ``--device
cpu`` is given); the rest runs on the host (numpy/scipy), as in the JAX
package. The plots need matplotlib, and say so without it.
"""

from __future__ import annotations

import argparse
import json


def sew_main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--q_so3", type=float, default=0.99)
    p.add_argument("--q_r3", type=float, default=0.99)
    args = p.parse_args(argv)

    from openimucameracalibrator_torch.core import telemetry
    from openimucameracalibrator_torch.ops import sew as sew_mod

    tel = telemetry.read_generic_json(args.input_json_path)
    fps = (1.0 / float((tel.img_times[1:] - tel.img_times[:-1]).mean())
           if tel.img_times is not None and len(tel.img_times) > 1 else 30.0)
    out = sew_mod.compute_sew(tel.imu, fps, q_so3=args.q_so3, q_r3=args.q_r3)
    result = {
        "so3": {"knot_spacing": out.dt_so3, "weighting_factor": out.std_so3,
                "quality_factor": args.q_so3},
        "r3": {"knot_spacing": out.dt_r3, "weighting_factor": out.std_r3,
               "quality_factor": args.q_r3},
        "camera_fps": out.cam_fps,
    }
    with open(args.output_path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"dt_so3={out.dt_so3:.3f}s dt_r3={out.dt_r3:.3f}s -> {args.output_path}")


def biases_main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--gravity_const", type=float, default=9.81)
    p.add_argument("--remove_sec", type=float, default=0.0)
    args = p.parse_args(argv)

    from openimucameracalibrator_torch.core import telemetry
    from openimucameracalibrator_torch.ops import sew as sew_mod

    tel = telemetry.read_generic_json(args.input_json_path, skip_seconds=args.remove_sec)
    ba, bg, source = sew_mod.estimate_static_biases(tel.imu, args.gravity_const)
    out = {"gyro_bias": {k: float(v) for k, v in zip("xyz", bg)},
           "accl_bias": {k: float(v) for k, v in zip("xyz", ba)},
           "bias_estimate": source}
    with open(args.output_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"biases -> {args.output_path}")


def board_main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_path", required=True)
    p.add_argument("--squares_x", type=int, default=10)
    p.add_argument("--squares_y", type=int, default=8)
    p.add_argument("--square_length", type=float, default=0.04)
    p.add_argument("--marker_length", type=float, default=0.03)
    p.add_argument("--px_per_square", type=int, default=100)
    args = p.parse_args(argv)

    from openimucameracalibrator_torch.core import board_extractor

    opts = board_extractor.BoardExtractorOptions(
        squares_x=args.squares_x, squares_y=args.squares_y,
        square_length=args.square_length, marker_length=args.marker_length)
    img = board_extractor.render_charuco_board_image(opts, args.px_per_square)
    board_extractor.save_image(args.output_path, img)
    print(f"board image -> {args.output_path}")


def extract_frames_main(argv=None):
    """Dump video frames to an image folder (reference
    python/extract_frames_from_video.py + python/utils.py:111-137)."""
    import os

    p = argparse.ArgumentParser()
    p.add_argument("--path_to_videofile", required=True)
    p.add_argument("--path_to_image_output", required=True)
    p.add_argument("--resize_factor", type=float, default=1.0)
    args = p.parse_args(argv)

    from openimucameracalibrator_torch.core import board_extractor

    os.makedirs(args.path_to_image_output, exist_ok=True)
    n = 0
    # downsample IS the shrink factor (frames resized by 1/downsample), so
    # --resize_factor 2 halves the frames like the reference
    # (python/utils.py:135 resizes by 1/resize_factor).
    for t_s, img in board_extractor.iter_video_frames(
            args.path_to_videofile, downsample=args.resize_factor):
        out = os.path.join(args.path_to_image_output, f"{int(t_s * 1e6):012d}.png")
        board_extractor.save_image(out, img)
        n += 1
    print(f"{n} frames -> {args.path_to_image_output}")


def static_imu_main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--telemetry_json", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--gravity_const", type=float, default=9.81)
    p.add_argument("--initial_static_duration_s", type=float, default=30.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs in float64)")
    args = p.parse_args(argv)

    from openimucameracalibrator_torch.core import static_imu_calibrator, telemetry

    tel = telemetry.read_generic_json(args.telemetry_json)
    acc, gyr, info = static_imu_calibrator.calibrate(
        tel.imu, static_imu_calibrator.StaticImuCalibratorOptions(
            gravity=args.gravity_const,
            init_static_duration_s=args.initial_static_duration_s), device=args.device)
    out = {
        "accelerometer": {"misalignment": acc.misalignment.tolist(),
                          "scale": acc.scale.tolist(), "bias": acc.bias.tolist()},
        "gyroscope": {"misalignment": gyr.misalignment.tolist(),
                      "scale": gyr.scale.tolist(), "bias": gyr.bias.tolist()},
        "info": {"num_intervals": info["num_intervals"],
                 "threshold_mult": info["threshold_mult"]},
    }
    with open(args.output_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"IMU intrinsics ({info['num_intervals']} poses) -> {args.output_path}")
    return info


def allan_main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--telemetry_json", required=True)
    p.add_argument("--output_path", default="")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs in float64)")
    args = p.parse_args(argv)

    from openimucameracalibrator_torch.core import telemetry
    from openimucameracalibrator_torch.ops import allan

    tel = telemetry.read_generic_json(args.telemetry_json)
    rate = tel.imu.rate_hz
    res_g = allan.analyze(tel.imu.gyro, rate, device=args.device)
    res_a = allan.analyze(tel.imu.accel, rate, device=args.device)
    out = {
        "gyro": {"white_noise_density": res_g.white_noise_density.tolist(),
                 "bias_instability": res_g.bias_instability.tolist(),
                 "random_walk": res_g.random_walk.tolist()},
        "accel": {"white_noise_density": res_a.white_noise_density.tolist(),
                  "bias_instability": res_a.bias_instability.tolist(),
                  "random_walk": res_a.random_walk.tolist()},
    }
    print(json.dumps(out, indent=1))
    if args.output_path:
        with open(args.output_path, "w") as f:
            json.dump(out, f, indent=1)


def debug_calib_main(argv=None):
    """Plot visual vs transformed-gyro angular velocities from the rotation
    initializer's debug dump (reference python/debug_calib.py, generalized:
    reads the result json instead of hard-coded txt paths)."""
    p = argparse.ArgumentParser()
    p.add_argument("--rotation_init_json", required=True,
                   help="output of estimate-imu-to-camera-rotation")
    p.add_argument("--output_png", default="")
    args = p.parse_args(argv)

    import numpy as np

    from openimucameracalibrator_torch.utils import diagnostics

    with open(args.rotation_init_json) as f:
        data = json.load(f)
    vis = np.asarray(data.get("debug_visual_ang_vel", []))
    imu = np.asarray(data.get("debug_imu_ang_vel_transformed", []))
    if vis.size == 0 or imu.size == 0:
        print("no debug angular-velocity dump in json (rerun with --debug_dump)")
        return
    plt = diagnostics.pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
    for c, ax in enumerate(axes):
        ax.plot(vis[:, c], "g", label="visual")
        ax.plot(imu[:, c], "b--", label="gyro (R applied)")
        ax.set_ylabel(f"w[{c}] rad/s")
    axes[0].legend()
    out = args.output_png or args.rotation_init_json + ".png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"plot -> {out}")


def result_stats_main(argv=None):
    """Replot spline-vs-IMU + bias evolution from a RESULT JSON alone
    (reference python/print_result_stats.py:24-95 -- works on result files
    written by either this framework or the reference binary, both of
    which carry the per-sample 'trajectory' block)."""
    p = argparse.ArgumentParser()
    p.add_argument("--path_results", required=True,
                   help="result json from continuous-time-calibration")
    p.add_argument("--output_png", default="")
    args = p.parse_args(argv)

    from openimucameracalibrator_torch.utils import diagnostics

    out = args.output_png or args.path_results + ".png"
    diagnostics.plot_result_stats(args.path_results, out)
    with open(args.path_results) as f:
        obj = json.load(f)
    for key in ("final_reproj_error", "time_offset_imu_to_cam_s",
                "calib_line_delay_us", "r3_dt", "so3_dt"):
        if key in obj:
            print(f"{key}: {obj[key]}")
    print(f"plot -> {out}")
