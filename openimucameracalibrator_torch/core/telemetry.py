"""Telemetry importers/exporters for all devices the reference supports.

Host-side numpy copy of ``core/telemetry.py`` of the JAX package, the
equivalent of the reference's TelemetryImporter / TelemetryConverter
(reference python/telemetry_converter.py): GoPro gpmf-parser json
(:73-132), pygpmf json (:285-344), pilotguru smartphone (:134-183),
generic csv (:185-209), generic json (:211-238), ZED jsonl (:240-283),
and the generic-json / Kalibr-csv writers (:387-435).

Conventions preserved from the reference:
* GoPro ACCL/GYRO samples are axis-remapped [1, 2, 0] (:91-93, 297-299).
* GoPro CORI quaternions arrive in (w, x, z, y) order (:96-99, 306-309);
  we store quaternions as (w, x, y, z).
* All timestamps are converted to seconds, float64 (the reference carries
  ns integers; seconds keep the internal APIs uniform).
"""

from __future__ import annotations

import csv
import json

import numpy as np

from openimucameracalibrator_torch.utils.types import (CameraTelemetry, GPSData,
                                                     ImuData)

NS = 1e-9
US = 1e-6
MS = 1e-3


def _skip(t, *arrays, skip_seconds=0.0):
    if skip_seconds <= 0.0:
        return (t,) + arrays
    lo, hi = t[0] + skip_seconds, t[-1] - skip_seconds
    m = (t >= lo) & (t <= hi)
    return (t[m],) + tuple(a[m] if len(a) == len(t) else a for a in arrays)


def read_gopro_telemetry(path: str, skip_seconds: float = 0.0) -> CameraTelemetry:
    """gpmf-parser json: streams ACCL/GYRO/CORI/GRAV(/GPS5)."""
    with open(path) as f:
        data = json.load(f)
    streams = data["1"]["streams"]
    accl_s = streams["ACCL"]["samples"]
    gyro_s = streams["GYRO"]["samples"]
    t = np.asarray([a["cts"] for a in accl_s], np.float64) * MS
    accl = np.asarray([a["value"] for a in accl_s], np.float64)[:, [1, 2, 0]]
    gyro = np.asarray([g["value"] for g in gyro_s], np.float64)[:, [1, 2, 0]]
    n = min(len(t), len(accl), len(gyro))
    t, accl, gyro = t[:n], accl[:n], gyro[:n]

    img_t = None
    quats = None
    if "CORI" in streams:
        cori = np.asarray([c["value"] for c in streams["CORI"]["samples"]], np.float64)
        # (w, x, z, y) -> (w, x, y, z)
        quats = cori[:, [0, 1, 3, 2]]
        img_t = np.asarray([c["cts"] for c in streams["CORI"]["samples"]], np.float64) * MS
    gps = None
    if "GPS5" in streams:
        # GPS5 sample value: [lat deg, lon deg, alt m, speed2d, speed3d]
        # (telemetry_converter.py:104-118).
        s = streams["GPS5"]["samples"]
        v = np.asarray([x["value"] for x in s], np.float64)
        gps = GPSData(times=np.asarray([x["cts"] for x in s], np.float64) * MS,
                      llh=v[:, :3],
                      precision=np.asarray(
                          [x.get("precision", 0.0) for x in s], np.float64),
                      vel3d=v[:, 4] if v.shape[1] > 4 else None)
    t, accl, gyro = _skip(t, accl, gyro, skip_seconds=skip_seconds)
    return CameraTelemetry(imu=ImuData(times=t, accel=accl, gyro=gyro),
                           img_times=img_t, cam_quats=quats, gps=gps)


def read_pygpmf_json(path: str, skip_seconds: float = 0.0) -> CameraTelemetry:
    """py_gpmf_parser json (run_gopro_calibration.py:198-206 path)."""
    with open(path) as f:
        data = json.load(f)
    accl = np.asarray(data["ACCL"]["data"], np.float64)[:, [1, 2, 0]]
    gyro = np.asarray(data["GYRO"]["data"], np.float64)[:, [1, 2, 0]]
    t = np.asarray(data["ACCL"]["timestamps_s"], np.float64)
    n = min(len(t), len(accl), len(gyro))
    t, accl, gyro = t[:n], accl[:n], gyro[:n]
    img_t = np.asarray(data["img_timestamps_s"], np.float64)
    quats = None
    if "CORI" in data:
        cori = np.asarray(data["CORI"]["data"], np.float64)
        quats = cori[:, [0, 1, 3, 2]]
    gps = None
    if "GPS5" in data:
        v = np.asarray(data["GPS5"]["data"], np.float64)
        gps = GPSData(times=np.asarray(data["GPS5"]["timestamps_s"], np.float64),
                      llh=v[:, :3],
                      vel3d=v[:, 4] if v.shape[1] > 4 else None)
    t, accl, gyro = _skip(t, accl, gyro, skip_seconds=skip_seconds)
    return CameraTelemetry(imu=ImuData(times=t, accel=accl, gyro=gyro),
                           img_times=img_t, cam_quats=quats, gps=gps)


def read_generic_json(path: str, skip_seconds: float = 0.0) -> CameraTelemetry:
    """The pipeline's interchange format (read_telemetry.cc:29-70)."""
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


def read_pilotguru(accl_path: str, gyro_path: str, cam_path: str,
                   skip_seconds: float = 0.0) -> CameraTelemetry:
    """pilotguru smartphone recorder (three json files, :134-183).

    The slower of the two IMU streams sets the shared timebase; the faster
    one is subsampled by the integer rate ratio, matching the reference.
    Camera frame 0 defines t = 0.
    """
    with open(accl_path) as f:
        acc_data = json.load(f)["accelerations"]
    with open(gyro_path) as f:
        gyr_data = json.load(f)["rotations"]
    with open(cam_path) as f:
        cam_data = json.load(f)["frames"]
    cam_t0 = cam_data[0]["time_usec"]
    acc_t = np.asarray([a["time_usec"] for a in acc_data], np.float64)
    gyr_t = np.asarray([g["time_usec"] for g in gyr_data], np.float64)
    accl = np.asarray([[a["x"], a["y"], a["z"]] for a in acc_data], np.float64)
    gyro = np.asarray([[g["x"], g["y"], g["z"]] for g in gyr_data], np.float64)
    acc_ps = 1.0 / ((acc_t[1] - acc_t[0]) * US)
    gyr_ps = 1.0 / ((gyr_t[1] - gyr_t[0]) * US)
    if acc_ps > gyr_ps:
        sub = int(round(acc_ps / gyr_ps))
        accl = accl[::sub]
        t = (acc_t[::sub] - cam_t0) * US
    else:
        sub = int(round(gyr_ps / acc_ps))
        gyro = gyro[::sub]
        t = (gyr_t[::sub] - cam_t0) * US
    n = min(len(t), len(accl), len(gyro))
    t, accl, gyro = t[:n], accl[:n], gyro[:n]
    img_t = (np.asarray([fr["time_usec"] for fr in cam_data], np.float64) - cam_t0) * US
    t, accl, gyro = _skip(t, accl, gyro, skip_seconds=skip_seconds)
    return CameraTelemetry(imu=ImuData(times=t, accel=accl, gyro=gyro), img_times=img_t)


def read_generic_csv(path: str, skip_seconds: float = 0.0) -> CameraTelemetry:
    """MYNT-EYE style csv: t_ns, gx, gy, gz, ax, ay, az (:185-209)."""
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if row:
                rows.append([float(v) for v in row[:7]])
    arr = np.asarray(rows, np.float64)
    t = arr[:, 0] * NS
    gyro = arr[:, 1:4]
    accl = arr[:, 4:7]
    t, accl, gyro = _skip(t, accl, gyro, skip_seconds=skip_seconds)
    return CameraTelemetry(imu=ImuData(times=t, accel=accl, gyro=gyro))


def read_zed_jsonl(path: str, skip_seconds: float = 0.0) -> CameraTelemetry:
    """ZED recorder jsonl (:240-283)."""
    gyro, accl, imu_t, frame_t = [], [], [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            if "sensor" in d:
                if d["sensor"]["type"] == "gyroscope":
                    gyro.append(d["sensor"]["values"])
                    imu_t.append(d["time"])
                elif d["sensor"]["type"] == "accelerometer":
                    accl.append(d["sensor"]["values"])
            elif "frames" in d:
                frame_t.append(d["time"])
    imu_t = np.asarray(imu_t, np.float64)
    frame_t = np.asarray(frame_t, np.float64)
    gyro = np.asarray(gyro, np.float64)
    accl = np.asarray(accl, np.float64)
    n = min(len(imu_t), len(gyro), len(accl))
    imu_t, gyro, accl = imu_t[:n], gyro[:n], accl[:n]
    keep = (imu_t >= frame_t[0]) & (imu_t <= frame_t[-1])
    imu_t, gyro, accl = imu_t[keep], gyro[keep], accl[keep]
    imu_t = imu_t - imu_t[0]
    t, accl, gyro = _skip(imu_t, accl, gyro, skip_seconds=skip_seconds)
    return CameraTelemetry(imu=ImuData(times=t, accel=accl, gyro=gyro),
                           img_times=frame_t - frame_t[0])


# ---------------------------------------------------------------------------
# Writers (TelemetryConverter equivalents)
# ---------------------------------------------------------------------------

def write_generic_json(tel: CameraTelemetry, path: str, cam_fps: float = 0.0):
    """Write the pipeline interchange json (:387-399)."""
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


def write_kalibr_csv(tel: CameraTelemetry, path: str):
    """Kalibr imu csv: t_ns, gx, gy, gz, ax, ay, az (:400-410)."""
    with open(path, "w") as f:
        for t, g, a in zip(tel.imu.times, tel.imu.gyro, tel.imu.accel):
            t_ns = int(round(t / NS))
            f.write(f"{t_ns},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")


# ---------------------------------------------------------------------------
# GPS utilities + multi-file tools
# ---------------------------------------------------------------------------

_WGS84_A = 6378137.0
_WGS84_E2 = 6.69437999014e-3


def geodetic_to_ecef(lat_deg, lon_deg, alt_m):
    """WGS84 geodetic -> ECEF (replaces the reference's pymap3d use,
    telemetry_converter.py:346-385). Accepts arrays."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt_m, np.float64)
    n = _WGS84_A / np.sqrt(1.0 - _WGS84_E2 * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - _WGS84_E2) + alt) * np.sin(lat)
    return np.stack([x, y, z], axis=-1)


def gps_positions_at_times(gps_times, gps_llh, query_times):
    """Interpolate ECEF GPS positions at arbitrary (e.g. frame) times
    (telemetry_converter.py get_gps_pos_at_frametimes)."""
    ecef = geodetic_to_ecef(gps_llh[:, 0], gps_llh[:, 1], gps_llh[:, 2])
    out = np.stack([np.interp(query_times, gps_times, ecef[:, k]) for k in range(3)], -1)
    inside = (query_times >= gps_times[0]) & (query_times <= gps_times[-1])
    return out, inside


def merge_telemetry(telemetries):
    """Concatenate several recordings end-to-end on a common timeline
    (python/merge_gopro_telemetry_from_folder.py equivalent; used to build
    long Allan-variance inputs)."""
    t_off = 0.0
    times, accel, gyro = [], [], []
    for tel in telemetries:
        t = np.asarray(tel.imu.times)
        times.append(t - t[0] + t_off)
        accel.append(tel.imu.accel)
        gyro.append(tel.imu.gyro)
        dt = float(np.median(np.diff(t))) if len(t) > 1 else 0.005
        t_off = times[-1][-1] + dt
    return CameraTelemetry(imu=ImuData(
        times=np.concatenate(times), accel=np.concatenate(accel),
        gyro=np.concatenate(gyro)))


def read_gopro_mp4(path: str, skip_seconds: float = 0.0) -> CameraTelemetry:
    """GoPro MP4 -> telemetry via the native GPMF reader (``core/gpmf.py``)."""
    from openimucameracalibrator_torch.core import gpmf

    return gpmf.read_gopro_mp4(path, skip_seconds)
