"""CLI: export frames + IMU csv for Kalibr cross-validation.

Port of ``apps/export_for_kalibr.py`` of the JAX package, the equivalent
of the reference's python/extract_for_kalibr_bagcreator.py:11-38 (frame
PNGs named by timestamp + imu csv), supporting the documented Kalibr
comparison workflow (docs/compare_to_kalibr.md:1-39). Host only; decoding
the video needs cv2, and the run says so without it.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video", required=True)
    p.add_argument("--telemetry_json", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--subsample", type=int, default=1)
    args = p.parse_args(argv)

    try:
        import cv2
    except ImportError as e:
        raise ImportError("export_for_kalibr decodes the video with cv2 (opencv-python), "
                          "which is not installed") from e

    from openimucameracalibrator_torch.core import telemetry

    os.makedirs(os.path.join(args.output_dir, "cam0"), exist_ok=True)
    tel = telemetry.read_generic_json(args.telemetry_json)
    telemetry.write_kalibr_csv(tel, os.path.join(args.output_dir, "imu0.csv"))

    cap = cv2.VideoCapture(args.video)
    k = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if k % args.subsample == 0:
            t_ns = int(round(cap.get(cv2.CAP_PROP_POS_MSEC) * 1e6))
            cv2.imwrite(os.path.join(args.output_dir, "cam0", f"{t_ns}.png"), frame)
        k += 1
    cap.release()
    print(f"exported {k} frames + imu csv -> {args.output_dir}")


if __name__ == "__main__":
    main()
