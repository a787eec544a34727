"""Synthetic calibration scenes: the benchmark's frozen copy of the port's
``utils/synthetic.py`` (``make_intrinsics_scene``, ``make_imu_camera_scene``
and what they need), trimmed to the two camera models the cells use.

It imports nothing of the port, so a later change to the port's generator,
its Lie helpers or its camera models cannot change the benchmark's inputs.
``benchmarks/tests/test_bench_frozen.py`` holds it equal to the port's
functions at a tiny size. Draws come from ``numpy.random.default_rng`` in
the port's order, so the same seed gives the same scene as the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jvp

GRAVITY = 9.81
_EPS = 1e-9


# --- rotations (unit quaternions, w first) ---------------------------------

def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_multiply(q, p):
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack([qw * pw - qx * px - qy * py - qz * pz,
                        qw * px + qx * pw + qy * pz - qz * py,
                        qw * py - qx * pz + qy * pw + qz * px,
                        qw * pz + qx * py - qy * px + qz * pw], dim=-1)


def quat_conjugate(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_rotate(q, v):
    w, u = q[..., 0:1], q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def so3_exp(phi):
    sq = torch.sum(phi * phi, dim=-1)
    theta = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))),
                        torch.zeros_like(sq))[..., None]
    k = torch.where(theta < 1e-4, 0.5 - theta * theta / 48.0,
                    torch.sin(0.5 * theta) / torch.where(theta > 0, theta, torch.ones_like(theta)))
    return torch.cat([torch.cos(0.5 * theta), k * phi], dim=-1)


def se3_compose(qa, ta, qb, tb):
    return quat_multiply(qa, qb), quat_rotate(qa, tb) + ta


def se3_inverse(q, t):
    qi = quat_conjugate(q)
    return qi, -quat_rotate(qi, t)


def se3_act(q, t, p):
    return quat_rotate(q, p) + t


def rotation_angle(q_a, q_b) -> float:
    """Angle in radians between two unit quaternions (host arrays)."""
    d = abs(float(np.dot(np.asarray(q_a, np.float64), np.asarray(q_b, np.float64))))
    return 2.0 * float(np.arccos(min(1.0, d)))


# --- camera models ----------------------------------------------------------

def _safe_div(a, b):
    sign_eps = torch.where(b >= 0, torch.full_like(b, _EPS), torch.full_like(b, -_EPS))
    return a / torch.where(torch.abs(b) > _EPS, b, sign_eps)


def _divundist_project(params, p):
    f, cx, cy, d = (params[..., i] for i in range(4))
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    xu, yu = f * _safe_div(x, z), f * _safe_div(y, z)
    ru2 = xu * xu + yu * yu
    disc = torch.clamp(1.0 - 4.0 * d * ru2, min=0.0)
    s = 2.0 / (1.0 + torch.sqrt(disc))
    return (torch.stack([s * xu + cx, s * yu + cy], -1),
            (z > _EPS) & (1.0 - 4.0 * d * ru2 > 0))


def _ds_project(params, p):
    fx, fy, cx, cy, xi, alpha = (params[..., i] for i in range(6))
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d1 = torch.sqrt(x * x + y * y + z * z)
    zeta = xi * d1 + z
    d2 = torch.sqrt(x * x + y * y + zeta * zeta)
    denom = alpha * d2 + (1.0 - alpha) * zeta
    u = fx * _safe_div(x, denom) + cx
    v = fy * _safe_div(y, denom) + cy
    w1 = torch.where(alpha > 0.5, (1.0 - alpha) / torch.clamp(alpha, min=_EPS),
                     alpha / torch.clamp(1.0 - alpha, min=_EPS))
    w2 = (w1 + xi) / torch.sqrt(torch.clamp(2.0 * w1 * xi + xi * xi + 1.0, min=_EPS))
    return torch.stack([u, v], -1), (denom > _EPS) & (z > -w2 * d1)


PROJECT = {"division_undistortion": _divundist_project, "double_sphere": _ds_project}


def charuco_points(squares_x: int = 10, squares_y: int = 8, square_length: float = 0.04):
    """(N, 3) inner chessboard corners of a charuco board, OpenCV's row-major
    corner ids, board +y image-down, z = 0."""
    nx, ny = squares_x - 1, squares_y - 1
    xs, ys = np.meshgrid(np.arange(1, nx + 1), np.arange(1, ny + 1))
    return np.stack([xs.ravel() * square_length, ys.ravel() * square_length,
                     np.zeros(nx * ny)], axis=-1).astype(np.float64)


# --- trajectories -----------------------------------------------------------

def sinusoid_trajectory(rng: np.random.Generator, pos_center=(0.2, 0.15, 0.75),
                        pos_amp=0.25, rot_amp=0.35, n_harmonics: int = 3,
                        base_freq: float = 0.4, q_base=None, *, device):
    """Smooth SE(3) body trajectory t -> (q_w_b, p_w) about the base pose
    (``pos_center``, ``q_base``; by default the body looks down -z at the
    board at z = 0), from four draws of ``rng``."""
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
    q_base = so3_exp(T([np.pi, 0.0, 0.0])) if q_base is None else T(q_base)

    def pose(t):
        ph = 2 * np.pi * freqs * t[..., None]
        p = center + torch.sum(amp_p * torch.sin(ph[..., None] + phase_p), dim=-2)
        r = torch.sum(amp_r * torch.sin(ph[..., None] + phase_r), dim=-2)
        return quat_multiply(so3_exp(r), q_base.expand(r.shape[:-1] + (4,))), p

    return pose


def pose_derivatives(pose_fn, t):
    """(q, p, omega_body, vel_w, acc_w) at times t, by nested jvp."""
    ones = torch.ones_like(t)
    (q, p), (dq, dp) = jvp(pose_fn, (t,), (ones,))
    omega = 2.0 * quat_multiply(quat_conjugate(q), dq)[..., 1:4]

    def vel(tt):
        return jvp(pose_fn, (tt,), (torch.ones_like(tt),))[1][1]

    acc = jvp(vel, (t,), (ones,))[1]
    return q, p, omega, dp, acc


# --- scenes -----------------------------------------------------------------

@dataclasses.dataclass
class Scene:
    """One ground truth and what it renders. Host float64 arrays."""

    model_name: str
    cam_params: np.ndarray
    image_size: tuple
    board_points: np.ndarray
    frame_times: np.ndarray     # (V,) camera clock
    q_w_c: np.ndarray
    t_w_c: np.ndarray
    observations: np.ndarray    # (V, P, 2) pixels
    obs_valid: np.ndarray       # (V, P)
    imu_times: np.ndarray | None = None
    accel: np.ndarray | None = None
    gyro: np.ndarray | None = None
    q_i_c: np.ndarray | None = None
    t_i_c: np.ndarray | None = None
    time_offset: float = 0.0
    line_delay: float = 0.0
    accel_bias: np.ndarray | None = None
    gyro_bias: np.ndarray | None = None
    pose_fn: object = None


def _visible(uv, ok, p_cam_z, image_size):
    w, h = image_size
    return (ok & (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
            & (p_cam_z > 0.05))


def make_intrinsics_scene(model_name: str, cam_params, *, num_views: int = 40,
                          image_size=(960, 540), noise_px: float = 0.2, seed: int = 0,
                          noise_seed: int | None = None, device) -> Scene:
    """Static board, moving camera (float64 on ``device``): the views an
    intrinsics recording gives. The trajectory is drawn from ``seed``, the
    corner noise from ``noise_seed`` (default ``seed + 1``, as the port)."""
    project = PROJECT[model_name]

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    pose_fn = sinusoid_trajectory(np.random.default_rng(seed), device=device)
    times = np.linspace(0.0, 1.0 / 0.4 * 0.9, num_views)
    qs, ps = pose_fn(T(times))
    pts = charuco_points()
    q_c_w, t_c_w = se3_inverse(qs, ps)
    p_cam = se3_act(q_c_w[..., None, :], t_c_w[..., None, :], T(pts))
    uv, ok = project(T(cam_params), p_cam)
    valid = _visible(uv, ok, p_cam[..., 2], image_size)
    noise_rng = np.random.default_rng(seed + 1 if noise_seed is None else noise_seed)
    noise = noise_rng.normal(size=tuple(uv.shape)) * noise_px
    return Scene(model_name, np.asarray(cam_params, np.float64), tuple(image_size), pts,
                 times, qs.cpu().numpy(), ps.cpu().numpy(), uv.cpu().numpy() + noise,
                 valid.cpu().numpy(), pose_fn=pose_fn)


def rig_rotation(device):
    """The rig's camera-to-IMU rotation: ~90 degrees about z, GoPro-like."""
    return so3_exp(torch.as_tensor([0.03, -0.02, np.pi / 2], dtype=torch.float64,
                                   device=device))


def project_rows(pose_fn, model_name, cam, pts, ft, q_i_c, t_i_c, line_delay, image_size,
                 iterations: int = 3):
    """(uv (V, P, 2), valid (V, P)) of board points ``pts`` (P, 3) seen at
    IMU times ``ft`` (V,) by the camera at T_imu_cam, each point at the time
    its row is read out (a fixed point, 3 iterations; global shutter when
    ``line_delay`` is 0)."""
    project = PROJECT[model_name]
    q_wi, p_wi = pose_fn(ft)
    q_wc, t_wc = se3_compose(q_wi, p_wi, q_i_c, t_i_c)
    q_cw, t_cw = se3_inverse(q_wc, t_wc)
    p_cam = se3_act(q_cw[..., None, :], t_cw[..., None, :], pts)
    uv, ok = project(cam, p_cam)
    valid = _visible(uv, ok, p_cam[..., 2], image_size)
    if line_delay > 0:
        for _ in range(iterations):
            qi, pi = pose_fn(ft[:, None] + line_delay * uv[..., 1])
            qc, tc = se3_compose(qi, pi, q_i_c, t_i_c)
            q_cw, t_cw = se3_inverse(qc, tc)
            p_cam = se3_act(q_cw, t_cw, pts)
            uv, ok = project(cam, p_cam)
            valid = _visible(uv, ok, p_cam[..., 2], image_size)
    return uv, valid, (q_wc, t_wc)


def make_imu_camera_scene(model_name: str, cam_params, *, duration: float = 20.0,
                          cam_fps: float = 30.0, imu_rate: float = 200.0,
                          image_size=(960, 540), noise_px: float = 0.2,
                          accel_noise: float = 0.02, gyro_noise: float = 0.002,
                          accel_bias=(0.05, -0.03, 0.08), gyro_bias=(0.004, -0.002, 0.003),
                          t_i_c=(0.01, -0.02, 0.001), time_offset: float = -0.05,
                          line_delay: float = 0.0, seed: int = 0,
                          noise_seed: int | None = None, device) -> Scene:
    """IMU + camera recording of one analytic body (IMU) trajectory, float64
    on ``device``. The IMU clock is the reference; frames are stamped on the
    camera clock t_cam = t_imu - time_offset; with ``line_delay`` > 0 row r
    is read out ``line_delay * r`` after the frame's time. The trajectory is
    drawn from ``seed``, the IMU and corner noise from ``noise_seed``
    (default ``seed + 2``, as the port)."""

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    q_i_c, t_i_c = rig_rotation(device), T(t_i_c)
    cam = T(cam_params)
    g_w = T([0.0, 0.0, GRAVITY])
    rng = np.random.default_rng(seed)
    pose_fn = sinusoid_trajectory(rng, rot_amp=0.3, pos_amp=0.18, device=device)

    imu_times = np.arange(0.0, duration, 1.0 / imu_rate)
    q, _, omega, _, acc = pose_derivatives(pose_fn, T(imu_times))
    f_b = quat_rotate(quat_conjugate(q), acc + g_w)
    noise_rng = np.random.default_rng(seed + 2 if noise_seed is None else noise_seed)
    accel = f_b + T(accel_bias) + accel_noise * T(noise_rng.normal(size=tuple(f_b.shape)))
    gyro = omega + T(gyro_bias) + gyro_noise * T(noise_rng.normal(size=tuple(omega.shape)))

    n_frames = int(duration * cam_fps) - 2
    frame_times_imu = np.arange(n_frames) / cam_fps + 0.5 / cam_fps
    pts = charuco_points()
    uv, valid, (q_wc, t_wc) = project_rows(pose_fn, model_name, cam, T(pts),
                                           T(frame_times_imu), q_i_c, t_i_c, line_delay,
                                           image_size)
    uv = uv + noise_px * T(noise_rng.normal(size=tuple(uv.shape)))

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    return Scene(model_name, np.asarray(cam_params, np.float64), tuple(image_size), pts,
                 frame_times_imu - time_offset, host(q_wc), host(t_wc), host(uv),
                 valid.cpu().numpy(), imu_times, host(accel), host(gyro), host(q_i_c),
                 host(t_i_c), time_offset, line_delay, np.asarray(accel_bias, np.float64),
                 np.asarray(gyro_bias, np.float64), pose_fn)
