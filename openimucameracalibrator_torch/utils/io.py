"""Artifact (de)serialization with reference-compatible schemas.

Port of the stage-8 subset of ``utils/io.py`` of the JAX package; the
file formats are the same, so artifacts move freely between the two
packages:

* corner datasets: the ".uson" UBJSON schema of board_extractor.cc
  (views/{t_us}/image_points/{id} = [x, y], scene_pts/{id} = [x, y, z],
  image_width/height, camera_fps) — board_extractor.cc:433-480.
* camera calibration json: write_camera_calibration.cc:33-140 /
  read_camera_calibration.cc:36-120 (intrinsic_type, focal_length,
  principal_pt_x/y, model-specific distortion entries).
* imu-camera result json: continuous_time_imu_to_camera_calibration.cc:
  247-332 (q_i_c, t_i_c, time offset, line delay, gravity, biases).
"""

from __future__ import annotations

import json

import numpy as np

from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.utils import ubjson
from openimucameracalibrator_torch.utils.types import CameraCalibration, CornerDataset


# --- corner datasets -------------------------------------------------------

def corners_to_dict(ds: CornerDataset) -> dict:
    views = {}
    for v in range(ds.num_views):
        t_us = str(int(round(ds.times[v] * 1e6)))
        pts = {}
        ids = np.nonzero(ds.valid[v])[0]
        for i in ids:
            pts[str(int(i))] = [float(ds.points2d[v, i, 0]), float(ds.points2d[v, i, 1])]
        views[t_us] = {"image_points": pts}
    scene_pts = {str(int(i)): [float(x) for x in ds.board_points[i]]
                 for i in range(ds.num_points)}
    return {"views": views, "scene_pts": scene_pts,
            "image_width": int(ds.image_size[0]),
            "image_height": int(ds.image_size[1]),
            "camera_fps": float(ds.fps)}


def dict_to_corners(data: dict) -> CornerDataset:
    scene = data["scene_pts"]
    ids = sorted(int(k) for k in scene.keys())
    id_to_slot = {i: s for s, i in enumerate(ids)}
    board_pts = np.asarray([scene[str(i)] for i in ids], np.float64)
    P = len(ids)
    items = sorted(data["views"].items(), key=lambda kv: int(kv[0]))
    V = len(items)
    times = np.asarray([int(k) * 1e-6 for k, _ in items])
    pts2d = np.zeros((V, P, 2))
    valid = np.zeros((V, P), bool)
    for v, (_, view) in enumerate(items):
        for sid, xy in view["image_points"].items():
            slot = id_to_slot.get(int(sid))
            if slot is not None:
                pts2d[v, slot] = xy
                valid[v, slot] = True
    return CornerDataset(times=times, points2d=pts2d, valid=valid,
                         board_points=board_pts,
                         image_size=(int(data["image_width"]), int(data["image_height"])),
                         fps=float(data.get("camera_fps", 0.0)))


def save_corners(ds: CornerDataset, path: str):
    """.uson (UBJSON) or .json by extension."""
    d = corners_to_dict(ds)
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(d, f)
    else:
        with open(path, "wb") as f:
            f.write(ubjson.dumps(d))


def load_corners(path: str) -> CornerDataset:
    if path.endswith(".json"):
        with open(path) as f:
            d = json.load(f)
    else:
        with open(path, "rb") as f:
            d = ubjson.loads(f.read())
    return dict_to_corners(d)


# --- camera calibration ----------------------------------------------------

_TYPE_BY_MODEL = {
    "pinhole": "PINHOLE",
    "pinhole_radtan": "PINHOLE_RADIAL_TANGENTIAL",
    "division_undistortion": "DIVISION_UNDISTORTION",
    "double_sphere": "DOUBLE_SPHERE",
    "extended_unified": "EXTENDED_UNIFIED",
    "fov": "FOV",
    "fisheye": "FISHEYE",
}
_MODEL_BY_TYPE = {v: k for k, v in _TYPE_BY_MODEL.items()}


def save_camera_calibration(calib: CameraCalibration, path: str,
                            nr_calib_images: int = 0):
    model = cameras.get_model(calib.model_name)
    p = np.asarray(calib.params, np.float64)
    g = model.param_groups
    fx = p[g["focal"][0]]
    fy = p[g["focal"][-1]]
    obj = {
        "stabelized": False,  # sic: reference schema key
        "fps": calib.fps,
        "nr_calib_images": nr_calib_images,
        "final_reproj_error": calib.mean_reproj_error,
        "image_width": int(calib.image_size[0]),
        "image_height": int(calib.image_size[1]),
        "intrinsic_type": _TYPE_BY_MODEL[model.name],
        "intrinsics": {
            "skew": 0.0,
            "focal_length": float(fx),
            "aspect_ratio": float(fy / fx),
            "principal_pt_x": float(p[g["pp"][0]]),
            "principal_pt_y": float(p[g["pp"][1]]),
        },
    }
    intr = obj["intrinsics"]
    if model.name == "division_undistortion":
        intr["div_undist_distortion"] = float(p[3])
    elif model.name == "double_sphere":
        intr["xi"], intr["alpha"] = float(p[4]), float(p[5])
    elif model.name == "extended_unified":
        intr["alpha"], intr["beta"] = float(p[4]), float(p[5])
    elif model.name == "fisheye":
        for k in range(4):
            intr[f"radial_distortion_{k + 1}"] = float(p[4 + k])
    elif model.name == "pinhole_radtan":
        intr["radial_distortion_1"] = float(p[4])
        intr["radial_distortion_2"] = float(p[5])
        intr["radial_distortion_3"] = float(p[6])
        intr["tangential_distortion_1"] = float(p[7])
        intr["tangential_distortion_2"] = float(p[8])
    elif model.name == "fov":
        intr["omega"] = float(p[4])
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def load_camera_calibration(path: str) -> CameraCalibration:
    with open(path) as f:
        obj = json.load(f)
    name = _MODEL_BY_TYPE[obj["intrinsic_type"]]
    intr = obj["intrinsics"]
    f0 = intr["focal_length"]
    fy = f0 * intr.get("aspect_ratio", 1.0)
    cx, cy = intr["principal_pt_x"], intr["principal_pt_y"]
    if name == "pinhole":
        p = [f0, fy, cx, cy]
    elif name == "division_undistortion":
        p = [f0, cx, cy, intr.get("div_undist_distortion", 0.0)]
    elif name == "double_sphere":
        p = [f0, fy, cx, cy, intr.get("xi", 0.0), intr.get("alpha", 0.5)]
    elif name == "extended_unified":
        p = [f0, fy, cx, cy, intr.get("alpha", 0.5), intr.get("beta", 1.0)]
    elif name == "fisheye":
        p = [f0, fy, cx, cy] + [intr.get(f"radial_distortion_{k + 1}", 0.0)
                                for k in range(4)]
    elif name == "pinhole_radtan":
        p = [f0, fy, cx, cy,
             intr.get("radial_distortion_1", 0.0), intr.get("radial_distortion_2", 0.0),
             intr.get("radial_distortion_3", 0.0),
             intr.get("tangential_distortion_1", 0.0),
             intr.get("tangential_distortion_2", 0.0)]
    elif name == "fov":
        p = [f0, fy, cx, cy, intr.get("omega", 0.85)]
    else:
        raise KeyError(name)
    return CameraCalibration(
        model_name=name, params=np.asarray(p, np.float64),
        image_size=(int(obj["image_width"]), int(obj["image_height"])),
        mean_reproj_error=float(obj.get("final_reproj_error", 0.0)),
        fps=float(obj.get("fps", 0.0)))


# --- imu-camera result -----------------------------------------------------

def _trajectory_dump(problem, params) -> dict:
    """Reference-schema per-sample trajectory block: for every IMU sample
    inside the spline support, the measured value, the spline prediction
    (bias excluded), and the bias-spline value, keyed by the nanosecond
    timestamp."""
    import torch

    from openimucameracalibrator_torch.core import spline_estimator as se

    traj: dict = {}

    def vec(v):
        return {k: round(float(x), 8) for k, x in zip("xyz", v)}

    def add(times, meas, names):
        # float64 keys: float32 scalar math would round the ns timestamps
        t = times.detach().cpu().numpy().astype(np.float64)
        tt = torch.as_tensor(t, dtype=times.dtype, device=times.device)
        ok = se._in_range(problem, tt).cpu().numpy()
        t, m = t[ok], meas.detach().cpu().numpy()[ok]
        comps = se.evaluate_imu_components(problem, params, tt[torch.as_tensor(ok, device=tt.device)])
        acc_s, gyr_s, ba, bg = (a.detach().cpu().numpy() for a in comps)
        spline_v = {"accl": acc_s, "gyro": gyr_s}[names]
        bias_v = {"accl": ba, "gyro": bg}[names]
        for i, ti in enumerate(t):
            key = str(int(round(ti * 1e9)))
            entry = traj.setdefault(key, {})
            entry[f"{names}_imu"] = vec(m[i])
            entry[f"{names}_spline"] = vec(spline_v[i])
            entry[f"{names}_bias"] = vec(bias_v[i])

    add(problem.gyro_t, problem.gyro_meas, "gyro")
    add(problem.accel_t, problem.accel_meas, "accl")
    return traj


def save_imu_camera_result(result, path: str, trajectory: bool = True):
    """Result json in the reference schema (q_i_c/t_i_c, final_reproj_error,
    r3_dt/so3_dt, line delays in us, time offset, per-sample spline-vs-IMU
    trajectory and bias evolution) plus gravity, solver status, cost
    history and per-view RMSE.

    ``trajectory=False`` skips the per-sample dump (it dominates file
    size: ~4 entries per IMU sample)."""
    obj = {
        "q_i_c": {k: float(v) for k, v in zip("wxyz", result.q_i_c)},
        "t_i_c": {k: float(v) for k, v in zip("xyz", result.t_i_c)},
        "time_offset_imu_to_cam_s": result.time_offset,
        # legacy alias kept for earlier artifacts
        "time_offset_imu_to_cam": result.time_offset,
        "final_reproj_error": result.mean_reproj_error,
        "calib_line_delay_us": result.line_delay * 1e6,
        "cam_line_delay": result.line_delay,
        "gravity": {k: float(v) for k, v in zip("xyz", result.gravity)},
        "iterations": result.iterations,
        "final_cost": result.final_cost,
    }
    problem = getattr(result, "problem", None)
    params = getattr(result, "params", None)
    if problem is not None:
        obj["r3_dt"] = float(problem.dt_r3)
        obj["so3_dt"] = float(problem.dt_so3)
    if getattr(result, "init_line_delay", None) is not None:
        obj["init_line_delay_us"] = float(result.init_line_delay) * 1e6
    if getattr(result, "solver_status", ""):
        obj["solver_status"] = result.solver_status
    if getattr(result, "cost_history", None) is not None:
        obj["cost_history"] = [float(c) for c in result.cost_history]
    if getattr(result, "stages", None) is not None:
        obj["lm_stages"] = result.stages
    if getattr(result, "per_view_rmse", None) is not None:
        obj["per_view_rmse"] = [None if np.isnan(v) else round(float(v), 5)
                                for v in result.per_view_rmse]
    if trajectory and problem is not None and params is not None:
        obj["trajectory"] = _trajectory_dump(problem, params)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def load_imu_camera_result(path: str) -> dict:
    """Load a result json (this package's, the JAX package's or the
    reference binary's: all carry the same keys)."""
    with open(path) as f:
        return json.load(f)


# --- IMU intrinsics (static multi-pose output -> batch stage) ---------------

def load_imu_intrinsics(path: str):
    """(accel ImuIntrinsics, gyro ImuIntrinsics) from a static-calibration
    json."""
    from openimucameracalibrator_torch.utils.types import ImuIntrinsics

    with open(path) as f:
        obj = json.load(f)

    def parse(sec):
        return ImuIntrinsics(
            misalignment=np.asarray(sec["misalignment"], np.float64),
            scale=np.asarray(sec["scale"], np.float64),
            bias=np.asarray(sec.get("bias", [0.0, 0.0, 0.0]), np.float64))

    return parse(obj["accelerometer"]), parse(obj["gyroscope"])
