"""CLI: camera intrinsic calibration from a corner file.

Port of ``apps/calibrate_camera.py`` of the JAX package, with the same
flags plus ``--device`` (default ``cuda``; without a CUDA device the run
raises unless ``--device cpu`` is given; the CPU runs in float64, the
card in float32).

    python -m openimucameracalibrator_torch.apps.calibrate_camera \\
        --input_corners corners.uson --save_path_calib_dataset calib.json
"""

from __future__ import annotations

import argparse


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_corners", required=True)
    p.add_argument("--save_path_calib_dataset", required=True, help="output calib json")
    p.add_argument("--camera_model_to_calibrate", default="DIVISION_UNDISTORTION")
    p.add_argument("--grid_size", type=float, default=0.04)
    p.add_argument("--min_num_views", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs in float64)")
    return p


def run(args) -> str:
    from openimucameracalibrator_torch.core import camera_calibrator
    from openimucameracalibrator_torch.utils import io, precision

    device = precision.resolve_device(args.device)
    ds = io.load_corners(args.input_corners)
    calib, details = camera_calibrator.calibrate_camera(
        ds, args.camera_model_to_calibrate,
        camera_calibrator.CameraCalibratorOptions(
            grid_size=args.grid_size, min_num_views=args.min_num_views),
        device=device)
    io.save_camera_calibration(calib, args.save_path_calib_dataset,
                               nr_calib_images=int(details["active"].sum()))
    print(f"initialization + view dedup: {details['init_seconds']:.3f} s, "
          f"{len(details['picked_views'])} of {ds.num_views} views picked")
    for i, st in enumerate(details["lm_stages"]):
        print(f"LM solve {i} (stage {st['stage']}): {st['iterations']} iterations, "
              f"{st['status']}, {st['seconds']:.3f} s, {st['valid_obs']} observations")
    print(f"model={calib.model_name} reproj_error={calib.mean_reproj_error:.4f}px "
          f"views={int(details['active'].sum())} -> {args.save_path_calib_dataset}")
    return args.save_path_calib_dataset


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
