"""The calibrate and batch cells' comparison: what the program answered
against the scene that the benchmark itself generated from the seed.

The scene's truth (``benchmarks/gen/scene.py``: the rig's T_imu_cam, clock
offset, line delay, camera parameters, IMU biases, gravity and corner noise)
is the plain reference: the generator is the forward model, independent of
the port, and the program's answer is judged by what it says about it.
Each number is a gap from the truth; the limits are in
``benchmarks/limits/<cell>.json``.
"""

from __future__ import annotations

import math

import numpy as np

from benchmarks.gen import scene as sc

GRAVITY = sc.GRAVITY


def expected_reproj_px(noise_px: float) -> float:
    """Mean length of a 2-D Gaussian corner error of ``noise_px`` per axis:
    what a fit that models the recording leaves, up to its few parameters."""
    return noise_px * math.sqrt(math.pi / 2.0)


def _finite(*xs) -> bool:
    return all(np.all(np.isfinite(np.asarray(x, np.float64))) for x in xs)


def rig_errors(truth: sc.Scene, q_i_c, t_i_c, time_offset, line_delay_s, reproj_px,
               noise_px: float) -> dict:
    """Gaps of one recording's stage-8 answer from the truth."""
    if not _finite(q_i_c, t_i_c, time_offset, line_delay_s, reproj_px):
        return {k: math.inf for k in ("rot_err_mrad", "offset_err_ms", "line_delay_err_pct",
                                      "t_ic_err_mm", "reproj_gap_pct")}
    q = np.asarray(q_i_c, np.float64)
    q = q / np.linalg.norm(q)
    exp = expected_reproj_px(noise_px)
    return {
        "rot_err_mrad": 1e3 * sc.rotation_angle(q, truth.q_i_c),
        "offset_err_ms": 1e3 * abs(float(time_offset) - truth.time_offset),
        "line_delay_err_pct": 100.0 * abs(float(line_delay_s) - truth.line_delay)
        / truth.line_delay,
        "t_ic_err_mm": 1e3 * float(np.linalg.norm(np.asarray(t_i_c, np.float64)
                                                   - truth.t_i_c)),
        "reproj_gap_pct": 100.0 * abs(float(reproj_px) - exp) / exp,
    }


def intrinsics_error_pct(model_name: str, params, truth_params) -> float:
    """Largest gap of the focal lengths and the principal point from the
    truth, as a share of the true focal length."""
    p, t = np.asarray(params, np.float64), np.asarray(truth_params, np.float64)
    if not _finite(p) or p.shape != t.shape:
        return math.inf
    n = 3 if model_name == "division_undistortion" else 4
    return 100.0 * float(np.max(np.abs(p[:n] - t[:n]))) / float(t[0])


def calibration_errors(config: dict, traffic: dict, truth: sc.Scene, answer: dict) -> dict:
    """Every compared number of one calibrate item."""
    s = answer["summary"]
    out = rig_errors(truth, s["q_i_c"], s["t_i_c"], s["time_offset_s"],
                     s["line_delay_us"] * 1e-6, s["final_reproj_error_px"], traffic["noise_px"])
    out["intr_err_pct"] = intrinsics_error_pct(truth.model_name, s["intrinsics_params"],
                                               truth.cam_params)
    g = np.asarray(s["gravity"], np.float64)
    out["gravity_err"] = abs(float(np.linalg.norm(g)) - GRAVITY) if _finite(g) else math.inf
    out["accel_bias_err"] = _gap(answer["bias_a"], truth.accel_bias)
    out["gyro_bias_err"] = _gap(answer["bias_g"], truth.gyro_bias)
    return out


def _gap(a, b) -> float:
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a - np.asarray(b, np.float64))) if _finite(a) else math.inf
