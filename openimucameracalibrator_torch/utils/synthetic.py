"""Synthetic calibration scenes: analytic trajectories, corners, IMU readings.

Port of ``utils/synthetic.py`` of the JAX package: an analytic, infinitely
differentiable ground-truth trajectory from which perfect (or
noise-perturbed) board corners and IMU measurements are rendered, so an
estimator can be validated by exact parameter recovery. Angular velocity
and linear acceleration come from the analytic pose by nested
``torch.func.jvp``.

Random numbers come from a seeded ``numpy.random.Generator``, so a scene
is reproducible but its draws differ from the JAX package's; the tests
feed both packages the same numpy inputs instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import jvp

from openimucameracalibrator_torch.models import boards as boards_mod
from openimucameracalibrator_torch.models.cameras import CameraModel
from openimucameracalibrator_torch.ops import lie
from openimucameracalibrator_torch.utils import precision

GRAVITY = 9.81


def sinusoid_trajectory(rng: np.random.Generator, duration: float,
                        pos_center=(0.2, 0.15, 0.75), pos_amp=0.25,
                        rot_amp=0.35, n_harmonics: int = 3,
                        base_freq: float = 0.4, q_base=None, *, device=None):
    """Random smooth SE(3) trajectory t -> (q_w_b, p_w) facing a board at z=0.

    By default the body looks down the -z world axis toward the board
    plane (board at z=0, camera at z ~ +0.75 looking back), with bounded
    sinusoid translation and rotation-vector wobble. Returns a callable of
    a time tensor of any shape (elementwise in t). ``duration`` is unused
    (the trajectory is defined for all t), as in the JAX package.
    """
    h = 1.0 + np.arange(n_harmonics)
    freqs = base_freq * h
    amp_p = pos_amp * rng.uniform(-1.0, 1.0, (n_harmonics, 3)) / h[:, None]
    phase_p = rng.uniform(0.0, 2 * np.pi, (n_harmonics, 3))
    amp_r = rot_amp * rng.uniform(-1.0, 1.0, (n_harmonics, 3)) / h[:, None]
    phase_r = rng.uniform(0.0, 2 * np.pi, (n_harmonics, 3))

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    freqs, amp_p, phase_p, amp_r, phase_r = map(T, (freqs, amp_p, phase_p, amp_r, phase_r))
    center = T(pos_center)
    if q_base is None:
        # camera/body z-axis pointing toward the board: pi about the x axis
        q_base = lie.so3_exp(T([np.pi, 0.0, 0.0]))
    q_base = T(q_base) if not isinstance(q_base, torch.Tensor) else q_base.double()

    def pose(t):
        ph = 2 * np.pi * freqs * t[..., None]  # (..., nh)
        p = center + torch.sum(amp_p * torch.sin(ph[..., None] + phase_p), dim=-2)
        r = torch.sum(amp_r * torch.sin(ph[..., None] + phase_r), dim=-2)
        return lie.quat_multiply(lie.so3_exp(r), q_base.expand(r.shape[:-1] + (4,))), p

    return pose


def pose_derivatives(pose_fn: Callable, t: torch.Tensor):
    """(q, p, omega_body, vel_w, acc_w) at times t via nested jvp."""
    ones = torch.ones_like(t)
    (q, p), (dq, dp) = jvp(pose_fn, (t,), (ones,))
    omega = 2.0 * lie.quat_multiply(lie.quat_conjugate(q), dq)[..., 1:4]

    def vel(tt):
        return jvp(pose_fn, (tt,), (torch.ones_like(tt),))[1][1]

    acc = jvp(vel, (t,), (ones,))[1]
    return q, p, omega, dp, acc


@dataclasses.dataclass
class SyntheticScene:
    """Everything a calibration test needs, from one ground truth."""

    board: boards_mod.Board
    cam_params: np.ndarray
    model: CameraModel
    image_size: tuple
    # Camera views
    frame_times: np.ndarray  # (V,)
    q_w_c: np.ndarray  # (V, 4) camera-to-world rotation
    t_w_c: np.ndarray  # (V, 3)
    observations: np.ndarray  # (V, P, 2) pixel corners
    obs_valid: np.ndarray  # (V, P) in-image mask
    # IMU
    imu_times: np.ndarray | None = None
    accel: np.ndarray | None = None
    gyro: np.ndarray | None = None
    q_i_c: np.ndarray | None = None  # extrinsics: camera-to-IMU
    t_i_c: np.ndarray | None = None
    time_offset: float = 0.0
    line_delay: float = 0.0
    gravity_w: np.ndarray | None = None
    pose_fn: Callable | None = None


def render_view(model: CameraModel, cam_params, board_pts, q_w_c, t_w_c, image_size):
    """Project board points (P, 3) into view(s) (..., 4)/(..., 3).

    Returns (uv (..., P, 2), valid (..., P))."""
    q_c_w, t_c_w = lie.se3_inverse(q_w_c, t_w_c)
    p_cam = lie.se3_act(q_c_w[..., None, :], t_c_w[..., None, :], board_pts)
    uv, ok = model.project(cam_params, p_cam)
    w, h = image_size
    inside = (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
    return uv, ok & inside & (p_cam[..., 2] > 0.05)


def make_intrinsics_scene(model: CameraModel, cam_params, *, num_views: int = 40,
                          image_size=(960, 540), noise_px: float = 0.2, seed: int = 0,
                          board: boards_mod.Board | None = None,
                          device=None) -> SyntheticScene:
    """Static board + moving camera: intrinsics-calibration test scene,
    rendered on ``device`` (default ``"cuda"``) in float64."""
    device = precision.resolve_device(device)
    board = board or boards_mod.charuco_board()

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    pose_fn = sinusoid_trajectory(np.random.default_rng(seed), duration=float(num_views),
                                  device=device)
    times = np.linspace(0.0, 1.0 / 0.4 * 0.9, num_views)  # cover most of a period
    qs, ps = pose_fn(T(times))
    uv, valid = render_view(model, T(cam_params), T(board.points), qs, ps, image_size)
    noise = np.random.default_rng(seed + 1).normal(size=tuple(uv.shape)) * noise_px
    uv = uv.cpu().numpy() + noise
    return SyntheticScene(
        board=board, cam_params=np.asarray(cam_params, np.float64), model=model,
        image_size=image_size, frame_times=times,
        q_w_c=qs.cpu().numpy(), t_w_c=ps.cpu().numpy(),
        observations=uv, obs_valid=valid.cpu().numpy(), pose_fn=pose_fn)


def make_imu_camera_scene(model: CameraModel, cam_params, *, duration: float = 20.0,
                          cam_fps: float = 30.0, imu_rate: float = 200.0,
                          image_size=(960, 540), noise_px: float = 0.2,
                          accel_noise: float = 0.02, gyro_noise: float = 0.002,
                          accel_bias=(0.05, -0.03, 0.08), gyro_bias=(0.004, -0.002, 0.003),
                          q_i_c=None, t_i_c=(0.01, -0.02, 0.001),
                          time_offset: float = -0.05, line_delay: float = 0.0,
                          seed: int = 0, board: boards_mod.Board | None = None,
                          device=None) -> SyntheticScene:
    """Full IMU+camera scene from one analytic body (IMU) trajectory,
    rendered on ``device`` (default ``"cuda"``) in float64.

    The IMU clock is the reference clock; camera frames are timestamped on
    the camera clock t_cam = t_imu - time_offset. If ``line_delay`` > 0,
    each observation is rendered at t + line_delay * row (rolling shutter).
    """
    device = precision.resolve_device(device)
    board = board or boards_mod.charuco_board()

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    if q_i_c is None:
        # GoPro-like: camera rotated ~90 deg about z relative to IMU.
        q_i_c = lie.so3_exp(T([0.03, -0.02, np.pi / 2]))
    q_i_c, t_i_c = T(q_i_c.cpu() if isinstance(q_i_c, torch.Tensor) else q_i_c), T(t_i_c)
    cam = T(cam_params)
    g_w = T([0.0, 0.0, GRAVITY])  # the residual uses a_w + g

    rng = np.random.default_rng(seed)
    pose_fn = sinusoid_trajectory(rng, duration, rot_amp=0.3, pos_amp=0.18, device=device)

    # --- IMU samples (body frame = IMU frame) ---
    imu_times = np.arange(0.0, duration, 1.0 / imu_rate)
    q, _, omega, _, acc = pose_derivatives(pose_fn, T(imu_times))
    # accelerometer measures R^T (a_w + g)
    f_b = lie.quat_rotate(lie.quat_conjugate(q), acc + g_w)
    noise_rng = np.random.default_rng(seed + 2)
    accel = f_b + T(accel_bias) + accel_noise * T(noise_rng.normal(size=tuple(f_b.shape)))
    gyro = omega + T(gyro_bias) + gyro_noise * T(noise_rng.normal(size=tuple(omega.shape)))

    # --- camera frames ---
    n_frames = int(duration * cam_fps) - 2
    frame_times_imu = np.arange(n_frames) / cam_fps + 0.5 / cam_fps
    ft = T(frame_times_imu)
    q_wi, p_wi = pose_fn(ft)
    q_wc, t_wc = lie.se3_compose(q_wi, p_wi, q_i_c, t_i_c)
    pts = T(board.points)
    uv, valid = render_view(model, cam, pts, q_wc, t_wc, image_size)
    if line_delay > 0:
        # Fixed-point iteration over the row-dependent capture time of every
        # point (line_delay * image_height << frame period: converges fast).
        for _ in range(3):
            t_rows = ft[:, None] + line_delay * uv[..., 1]  # (V, P)
            qi, pi = pose_fn(t_rows)
            qc, tc = lie.se3_compose(qi, pi, q_i_c, t_i_c)
            q_cw, t_cw = lie.se3_inverse(qc, tc)
            p_cam = lie.se3_act(q_cw, t_cw, pts)
            uv, ok = model.project(cam, p_cam)
            w, h = image_size
            valid = (ok & (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0)
                     & (uv[..., 1] < h) & (p_cam[..., 2] > 0.05))

    uv = uv + noise_px * T(noise_rng.normal(size=tuple(uv.shape)))

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    return SyntheticScene(
        board=board, cam_params=np.asarray(cam_params, np.float64), model=model,
        image_size=image_size,
        frame_times=frame_times_imu - time_offset,  # camera clock
        q_w_c=host(q_wc), t_w_c=host(t_wc),
        observations=host(uv), obs_valid=valid.cpu().numpy(),
        imu_times=imu_times, accel=host(accel), gyro=host(gyro),
        q_i_c=host(q_i_c), t_i_c=host(t_i_c),
        time_offset=time_offset, line_delay=line_delay,
        gravity_w=host(g_w), pose_fn=pose_fn)


def write_stage8_inputs(scene: SyntheticScene, out_dir: str, *, cam_fps: float,
                        dt_so3: float, dt_r3: float, std_so3: float, std_r3: float,
                        init_rot_err: float = 3e-3, init_time_err: float = 3e-3,
                        corners_ext: str = ".uson") -> dict:
    """Write the stage-8 input artifacts of a scene into ``out_dir``.

    Corners, camera calibration json, poses ``.npz`` (scene truth), generic
    telemetry json, SEW json, and the IMU-to-camera rotation init json,
    built from truth perturbed by ``init_rot_err`` rad about a fixed axis
    and ``init_time_err`` seconds: stage 8 alone, apart from the stages
    that make these artifacts (``apps/run_calibration.py`` runs those).
    Returns the CLI flags (without ``--output_path``) as a dict.
    """
    import json
    import os

    from openimucameracalibrator_torch.core import telemetry
    from openimucameracalibrator_torch.utils import io
    from openimucameracalibrator_torch.utils.types import (CameraCalibration, CameraTelemetry,
                                                           CornerDataset, ImuData)

    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, name) for k, name in (
        ("input_corners", "corners" + corners_ext), ("camera_calibration_json", "calib.json"),
        ("input_pose_dataset", "poses.npz"), ("telemetry_json", "telemetry.json"),
        ("imu_rotation_init", "init.json"), ("spline_weighting_json", "sew.json"))}
    io.save_corners(CornerDataset(times=scene.frame_times, points2d=scene.observations,
                                  valid=scene.obs_valid,
                                  board_points=np.asarray(scene.board.points),
                                  image_size=scene.image_size, fps=cam_fps),
                    paths["input_corners"])
    io.save_camera_calibration(CameraCalibration(scene.model.name, scene.cam_params,
                                                 scene.image_size, 0.0, fps=cam_fps),
                               paths["camera_calibration_json"])
    np.savez(paths["input_pose_dataset"], times=scene.frame_times, q_w_c=scene.q_w_c,
             t_w_c=scene.t_w_c, valid=np.ones(len(scene.frame_times), bool),
             board_points=np.asarray(scene.board.points))
    telemetry.write_generic_json(
        CameraTelemetry(imu=ImuData(times=scene.imu_times, accel=scene.accel, gyro=scene.gyro)),
        paths["telemetry_json"], cam_fps=cam_fps)
    # q_gyro_to_cam = conj(q_i_c), perturbed by a small rotation.
    axis = np.array([1.0, -2.0, 2.0]) / 3.0
    dq = lie.so3_exp(torch.as_tensor(axis * init_rot_err, dtype=torch.float64))
    q_c_i = lie.quat_conjugate(torch.as_tensor(scene.q_i_c, dtype=torch.float64))
    q0 = lie.quat_multiply(dq, q_c_i).numpy()
    with open(paths["imu_rotation_init"], "w") as f:
        json.dump({"gyro_to_camera_rotation": {k: float(v) for k, v in zip("wxyz", q0)},
                   "time_offset_gyro_to_cam": float(scene.time_offset + init_time_err),
                   "gyro_bias": {k: 0.0 for k in "xyz"}}, f, indent=1)
    with open(paths["spline_weighting_json"], "w") as f:
        json.dump({"so3": {"knot_spacing": dt_so3, "weighting_factor": std_so3},
                   "r3": {"knot_spacing": dt_r3, "weighting_factor": std_r3},
                   "camera_fps": cam_fps}, f, indent=1)
    return paths


# imu_tk-style sensor model of the multi-pose static IMU calibration scene:
# raw = (T K)^-1 true + b, accelerometer (T upper triangular) and gyroscope
# (T full), the values of the JAX package's tests/test_static_imu.py.
MULTIPOSE_TRUTH = {
    "accel_misalignment": np.array([[1.0, -0.01, 0.004], [0.0, 1.0, -0.006], [0.0, 0.0, 1.0]]),
    "accel_scale": np.array([1.02, 0.98, 1.01]),
    "accel_bias": np.array([0.15, -0.12, 0.2]),
    "gyro_misalignment": np.array([[1.0, -0.005, 0.003], [0.006, 1.0, -0.004],
                                   [-0.002, 0.008, 1.0]]),
    "gyro_scale": np.array([1.015, 0.985, 1.005]),
    "gyro_bias": np.array([0.01, -0.008, 0.012]),
}


def make_multipose_imu(rng: np.random.Generator, n_poses: int = 16, rate: float = 100.0,
                       static_s: float = 4.0, motion_s: float = 2.0,
                       init_static_s: float = 6.0):
    """Random tumble sequence for the static multi-pose IMU calibration:
    static poses joined by smooth rotations, raw readings per
    ``MULTIPOSE_TRUTH`` plus white noise (0.004 m/s^2, 0.001 rad/s).

    Host float64; ``rng``'s draws are taken in the order of the JAX
    package's ``tests/test_static_imu.make_multipose_data``, so the same
    seed gives the same data. Returns ``ImuData``.
    """
    from openimucameracalibrator_torch.utils.types import ImuData

    tr = MULTIPOSE_TRUTH
    tka_inv = np.linalg.inv(tr["accel_misalignment"] @ np.diag(tr["accel_scale"]))
    tkg_inv = np.linalg.inv(tr["gyro_misalignment"] @ np.diag(tr["gyro_scale"]))
    dt = 1.0 / rate
    g_w = torch.tensor([0.0, 0.0, GRAVITY], dtype=torch.float64)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    acc_true, gyr_true, noise = [], [], []

    def g_body(q):
        return lie.quat_rotate(lie.quat_conjugate(q), g_w).numpy()

    def emit(w_true, g_b):
        acc_true.append(g_b)
        gyr_true.append(w_true)
        noise.append(rng.normal(size=(len(w_true), 2, 3)))

    def emit_static(duration, q):
        n = int(duration * rate)
        emit(np.zeros((n, 3)), np.tile(g_body(q), (n, 1)))

    def emit_motion(duration, q):
        n = int(duration * rate)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        # Smooth bump rotation profile; quasi-static tumble (rotation about
        # the sensor), so the specific force stays gravity.
        w = axis * (np.sin(np.pi * np.arange(n) / n) ** 2)[:, None] * 1.6
        g_b = np.zeros((n, 3))
        for k in range(n):
            g_b[k] = g_body(q)
            q = lie.quat_multiply(q, lie.so3_exp(torch.as_tensor(w[k] * dt)))
        emit(w, g_b)
        return q

    emit_static(init_static_s, q)
    for _ in range(n_poses - 1):
        q = emit_motion(motion_s, q)
        emit_static(static_s, q)
    a, w, e = (np.concatenate(x) for x in (acc_true, gyr_true, noise))
    accel = a @ tka_inv.T + tr["accel_bias"] + e[:, 0] * 0.004
    gyro = w @ tkg_inv.T + tr["gyro_bias"] + e[:, 1] * 0.001
    # Times accumulate dt sample by sample, as the JAX test's clock does.
    times = np.concatenate([[0.0], np.cumsum(np.full(len(a) - 1, dt))])
    return ImuData(times=times, accel=accel, gyro=gyro)
