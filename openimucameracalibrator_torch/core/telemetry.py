"""Generic-json telemetry reader and writer.

Port of the generic-json part of ``core/telemetry.py`` of the JAX package
(the pipeline's interchange format). The device-specific importers are not
ported yet (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import json

import numpy as np

from openimucameracalibrator_torch.utils.types import CameraTelemetry, GPSData, ImuData

NS = 1e-9


def _skip(t, *arrays, skip_seconds=0.0):
    if skip_seconds <= 0.0:
        return (t,) + arrays
    lo, hi = t[0] + skip_seconds, t[-1] - skip_seconds
    m = (t >= lo) & (t <= hi)
    return (t[m],) + tuple(a[m] if len(a) == len(t) else a for a in arrays)


def read_generic_json(path: str, skip_seconds: float = 0.0) -> CameraTelemetry:
    """The pipeline's interchange format."""
    with open(path) as f:
        data = json.load(f)
    t = np.asarray(data["timestamps_ns"], np.float64) * NS
    accl = np.asarray(data["accelerometer"], np.float64)
    gyro = np.asarray(data["gyroscope"], np.float64)
    img_t = np.asarray(data.get("img_timestamps_ns", []), np.float64) * NS
    gps = None
    if data.get("gps_llh"):
        gps = GPSData(
            times=np.asarray(data["gps_timestamps_ns"], np.float64) * NS,
            llh=np.asarray(data["gps_llh"], np.float64),
            precision=(np.asarray(data["gps_precision"], np.float64)
                       if "gps_precision" in data else None),
            vel3d=(np.asarray(data["gps_vel3d"], np.float64)
                   if "gps_vel3d" in data else None))
    t, accl, gyro = _skip(t, accl, gyro, skip_seconds=skip_seconds)
    return CameraTelemetry(imu=ImuData(times=t, accel=accl, gyro=gyro),
                           img_times=img_t if img_t.size else None, gps=gps)


def write_generic_json(tel: CameraTelemetry, path: str, cam_fps: float = 0.0):
    """Write the pipeline interchange json."""
    out = {
        "accelerometer": np.asarray(tel.imu.accel).tolist(),
        "gyroscope": np.asarray(tel.imu.gyro).tolist(),
        "timestamps_ns": (np.asarray(tel.imu.times) / NS).tolist(),
        "img_timestamps_ns": ((np.asarray(tel.img_times) / NS).tolist()
                              if tel.img_times is not None else []),
        "camera_fps": cam_fps or (
            1.0 / float(np.mean(np.diff(tel.img_times)))
            if tel.img_times is not None and len(tel.img_times) > 1 else 0.0),
    }
    if tel.gps is not None:
        out["gps_timestamps_ns"] = (np.asarray(tel.gps.times) / NS).tolist()
        out["gps_llh"] = np.asarray(tel.gps.llh).tolist()
        if tel.gps.precision is not None:
            out["gps_precision"] = np.asarray(tel.gps.precision).tolist()
        if tel.gps.vel3d is not None:
            out["gps_vel3d"] = np.asarray(tel.gps.vel3d).tolist()
    with open(path, "w") as f:
        json.dump(out, f)
