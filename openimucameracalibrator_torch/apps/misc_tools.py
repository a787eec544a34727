"""CLI: the small pipeline tools.

Port of ``apps/misc_tools.py`` of the JAX package. Ported:

* ``sew_main`` — spline error weighting (reference
  python/get_sew_for_dataset.py:38-56)
* ``biases_main`` — static bias estimate (python/get_imu_biases.py:39-62)
* ``board_main`` — printable charuco board PNG (create_charuco_board.cc,
  the native renderer; PIL writes the PNG)
* ``extract_frames_main`` — video frames to a PNG folder (needs cv2 to
  decode, and says so without it)

All run on the host (numpy/scipy), as in the JAX package. The other
tools raise ``NotImplementedError`` naming the ROADMAP.md item that ports
them.
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


def _not_ported(tool: str, item: int, needs: str):
    def main(argv=None):
        raise NotImplementedError(f"misc_tools {tool} is not ported yet: it needs {needs} "
                                  f"(ROADMAP.md queue 1, item {item})")
    return main


static_imu_main = _not_ported("static-imu-calibration", 12,
                              "core/static_imu_calibrator.py")
allan_main = _not_ported("fit-allan-variance", 12, "ops/allan.py")
debug_calib_main = _not_ported("debug-calib", 11, "the pipeline's debug plots")
result_stats_main = _not_ported("result-stats", 12, "utils/diagnostics.py")
