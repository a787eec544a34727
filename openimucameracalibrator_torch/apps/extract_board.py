"""CLI: extract board corners from a video or image folder.

Port of ``apps/extract_board.py`` of the JAX package (the reference's
extract_board_to_json), with the same flags plus ``--device`` (default
``cuda``; without a CUDA device the run raises unless ``--device cpu`` is
given): charuco (default, the batched video detector), radon and apriltag
boards, and the detector-parameter file. ``--detector_kernel`` accepts
only ``auto``: the CUDA kernel on the card, its plain version on the CPU.
Video files need cv2 to decode; image folders are read with PIL.

    python -m openimucameracalibrator_torch.apps.extract_board \\
        --input_path frames/ --save_corners_to_path corners.uson
"""

from __future__ import annotations

import argparse
import os


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_path", required=True, help="video file or image folder")
    p.add_argument("--save_corners_to_path", required=True, help="output .uson/.json")
    p.add_argument("--board_type", default="charuco",
                   choices=["charuco", "radon", "apriltag"])
    p.add_argument("--squares_x", type=int, default=10)
    p.add_argument("--squares_y", type=int, default=8)
    p.add_argument("--square_length", type=float, default=0.04)
    p.add_argument("--marker_length", type=float, default=0.03)
    p.add_argument("--aruco_dict", default="DICT_ARUCO_ORIGINAL")
    p.add_argument("--downsample_factor", type=float, default=1.0)
    p.add_argument("--image_folder_fps", type=float, default=30.0)
    p.add_argument("--recompute_corners", action="store_true")
    p.add_argument("--detector_kernel", default="auto", choices=["auto"],
                   help="corner-response implementation: the CUDA kernel on the card, "
                        "its plain version on the CPU")
    p.add_argument("--aruco_detector_params", default="",
                   help="detector-parameter file, OpenCV-YAML or json "
                        "(reference charuco_detector_params.yml schema, "
                        "utils.cc:43-75; see detect/params.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    return p


def run(args) -> str:
    from openimucameracalibrator_torch.core import board_extractor
    from openimucameracalibrator_torch.utils import io, precision

    device = precision.resolve_device(args.device)
    out = args.save_corners_to_path
    if os.path.exists(out) and not args.recompute_corners:
        print(f"corner file {out} exists, skipping (use --recompute_corners)")
        return out
    opts = board_extractor.BoardExtractorOptions(
        board_type=args.board_type, squares_x=args.squares_x,
        squares_y=args.squares_y, square_length=args.square_length,
        marker_length=args.marker_length, aruco_dict=args.aruco_dict,
        downsample_factor=args.downsample_factor,
        detector_params_path=args.aruco_detector_params)
    if os.path.isdir(args.input_path):
        ds = board_extractor.extract_board_from_image_folder(
            args.input_path, args.image_folder_fps, opts, device=device)
    else:
        ds = board_extractor.extract_board_from_video(args.input_path, opts, device=device)
    io.save_corners(ds, out)
    print(f"extracted {int(ds.valid.sum())} corners over {ds.num_views} views -> {out}")
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
