"""IMU-to-camera rotation + time-offset initialization.

Port of ``core/imu_cam_rotation.py`` of the JAX package (the reference's
ImuToCameraRotationEstimator, imu_to_camera_rotation_estimator.cc:116-274):

1. visual body-frame angular velocities from differentiated camera
   orientation quaternions (:174-200),
2. moving-average smoothing of both signals (:203-218, 15 taps),
3. a coarse grid over the time offset in [-1, 1] s, then golden-section
   search inside the best valley (:220-262), with an inner closed-form
   Kabsch/SVD alignment + gyro-bias estimate and Huber scoring
   (``SolveClosedForm`` :39-114).

The inner solve runs on the device; the grid and the golden-section loop
run on the host, one scalar read per cost evaluation.

Times are rebased to the first IMU sample (in float64, on the host)
before they go to the device. The arithmetic is the same (every use is a
difference of times), but on the card the port runs in float32, whose
spacing at 1,000 s is 61 us: absolute timestamps would blur the offset
search, whose tolerance is 100 us.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openimucameracalibrator_torch.ops import interpolation, lie
from openimucameracalibrator_torch.utils import precision
from openimucameracalibrator_torch.utils.types import ImuCameraInit, ImuData, PoseDataset

HUBER_K = 1.345  # imu_to_camera_rotation_estimator.cc:36-37


def visual_angular_velocity(times: torch.Tensor, q_w_c: torch.Tensor) -> torch.Tensor:
    """Body-frame angular velocity from consecutive orientation quats.

    Central differences: omega_k = log(q_{k-1}^{-1} q_{k+1}) / (t_{k+1} -
    t_{k-1}), assigned at t_k (a forward difference assigned at t_k biases
    the time offset by +dt/2). Endpoints replicate their neighbors.
    """
    dq = lie.quat_multiply(lie.quat_conjugate(q_w_c[:-2]), q_w_c[2:])
    w = lie.so3_log(dq) / (times[2:] - times[:-2])[:, None]
    return torch.cat([w[:1], w, w[-1:]], dim=0)


def _alignment_cost(td, imu_times, gyro_s, vis_times, omega_vis_s, w):
    """Kabsch alignment at a candidate time offset; returns (cost, R, bias).

    Shifting camera timestamps by +td aligns them to the IMU clock:
    compare omega_vis(t) with gyro(t + td) resampled by lerp. ``w`` is a
    per-sample 0/1 weight (static shapes instead of dropping samples).
    """
    g = interpolation.interp_vector(imu_times, gyro_s, vis_times + td)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean_v = torch.sum(omega_vis_s * w[:, None], dim=0) / n
    mean_g = torch.sum(g * w[:, None], dim=0) / n
    A = ((omega_vis_s - mean_v) * w[:, None]).T @ (g - mean_g)
    U, _, Vt = torch.linalg.svd(A)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det])
    R = (U * D[None, :]) @ Vt  # omega_vis ~= R @ gyro_corrected
    bias = mean_g - R.T @ mean_v
    r = (omega_vis_s - (g - bias) @ R.T) * w[:, None]
    s = torch.linalg.vector_norm(r, dim=-1)
    huber = torch.where(s <= HUBER_K, 0.5 * s * s, HUBER_K * (s - 0.5 * HUBER_K))
    return torch.sum(huber), R, bias


@dataclasses.dataclass
class RotationEstimatorOptions:
    smooth_window: int = 15
    search_range_s: float = 1.0
    tol_s: float = 1e-4  # imu_to_camera_rotation_estimator.cc:222


def estimate_imu_to_camera_rotation(poses: PoseDataset, imu: ImuData,
                                    options: RotationEstimatorOptions | None = None,
                                    device=None) -> ImuCameraInit:
    """Golden-section search over time offset with closed-form alignment,
    on ``device`` (default ``"cuda"``; raises where no CUDA device is
    present unless ``device="cpu"``).

    Returns R_gyro->cam (as quaternion), the time offset to ADD to camera
    timestamps, and the estimated gyro bias.
    """
    opts = options or RotationEstimatorOptions()
    device = precision.resolve_device(device)
    dt = precision.default_dtype(device)
    ok = np.asarray(poses.valid, bool)
    if not ok.any():
        # The JAX package fails here with an IndexError on the empty set.
        raise ValueError(f"empty pose set: none of the {ok.size} views has a valid pose "
                         "(stage 5 posed no view), so there is no visual rotation to align")
    pose_t = np.asarray(poses.times, np.float64)[ok]
    # Fix quaternion hemisphere continuity before slerp.
    qn = np.array(poses.q_w_c, np.float64)[ok]
    for k in range(1, qn.shape[0]):
        if np.dot(qn[k], qn[k - 1]) < 0:
            qn[k] = -qn[k]

    imu_times = np.asarray(imu.times, np.float64)
    t0 = imu_times[0]

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt, device=device)

    # Resample the visual orientation to the IMU rate, then differentiate
    # and smooth BOTH signals with the same window at the same rate
    # (imu_to_camera_rotation_estimator.cc:168-218).
    imu_rate_dt = float(np.median(np.diff(imu_times)))
    vis_abs = np.arange(float(pose_t[0]), float(pose_t[-1]), imu_rate_dt)
    vis_t = T(vis_abs - t0)
    q = interpolation.interp_quaternion(T(pose_t - t0), T(qn), vis_t)
    omega_vis = visual_angular_velocity(vis_t, q)
    omega_vis_s = interpolation.moving_average(omega_vis, opts.smooth_window)
    gyro_s = interpolation.moving_average(T(imu.gyro), opts.smooth_window)
    imu_t = T(imu_times - t0)

    # Keep only visual samples whose shifted time stays inside the IMU
    # record for every probed offset.
    lo, hi = -opts.search_range_s, opts.search_range_s
    keep = T((vis_abs + hi <= imu_times[-1]) & (vis_abs + lo >= imu_times[0]))

    def cost(td):
        c, _, _ = _alignment_cost(torch.tensor(td, dtype=dt, device=device), imu_t, gyro_s,
                                  vis_t, omega_vis_s, keep)
        return float(c)

    # The Huber alignment cost is not unimodal over a +-1 s range (the
    # angular-velocity signals are oscillatory), so first locate the global
    # valley with a coarse grid, then refine with golden-section inside it.
    grid = np.arange(lo, hi + 1e-9, 0.01)
    costs = [cost(td) for td in grid]
    k = int(np.argmin(costs))
    lo = grid[max(k - 1, 0)]
    hi = grid[min(k + 1, len(grid) - 1)]

    # Golden-section (imu_to_camera_rotation_estimator.cc:220-262).
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c_ = b - (b - a) * invphi
    d_ = a + (b - a) * invphi
    fc, fd = cost(c_), cost(d_)
    while abs(b - a) > opts.tol_s:
        if fc < fd:
            b, d_, fd = d_, c_, fc
            c_ = b - (b - a) * invphi
            fc = cost(c_)
        else:
            a, c_, fc = c_, d_, fd
            d_ = a + (b - a) * invphi
            fd = cost(d_)
    td = 0.5 * (a + b)
    td_t = torch.tensor(td, dtype=dt, device=device)
    _, R, bias = _alignment_cost(td_t, imu_t, gyro_s, vis_t, omega_vis_s, keep)
    # omega_vis = R_c_g omega_gyro => R maps gyro frame into camera frame.
    q_gyro_to_cam = lie.matrix_to_quat(R)
    # Alignment diagnostics on the visual grid (debug_calib plotting).
    g_at_vis = interpolation.interp_vector(imu_t, gyro_s, vis_t + td_t)
    imu_transformed = (g_at_vis - bias) @ R.T

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    return ImuCameraInit(
        q_gyro_to_cam=host(q_gyro_to_cam), time_offset=float(td), gyro_bias=host(bias),
        debug_visual_ang_vel=host(omega_vis_s),
        debug_imu_ang_vel_transformed=host(imu_transformed))
