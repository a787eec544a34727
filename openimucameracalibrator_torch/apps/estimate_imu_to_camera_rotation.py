"""Loader of the IMU-to-camera rotation / time-offset initialization json.

Only the loader is ported so far (``load_imu_camera_init``); the stage
itself is ROADMAP.md queue 1, item 9.
"""

from __future__ import annotations

import json


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
