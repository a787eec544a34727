"""Per-frame camera pose estimation with fixed intrinsics.

Port of ``core/pose_estimator.py`` of the JAX package (the reference's
PoseEstimator, pose_estimator.cc:92-191 ``EstimatePosesFromJson``):
undistort corners to the normalized image plane, planar RANSAC per view,
per-view pose refinement, reprojection / median-z outlier filtering.

Every view is processed at once: RANSAC is one (views x hypotheses) batch
and the refinement a fixed number of damped Gauss-Newton steps on all
6-dof poses together (poses are independent given the intrinsics, so each
view's normal matrix is its own 6x6). The JAX package cut the views into
chunks of 512 to keep its compiler's working set bounded; eager PyTorch
compiles nothing, so the port runs one batch. The RANSAC uniforms of all
views come from one ``torch.Generator`` seeded by ``seed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, vmap
from torch.profiler import record_function

from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.ops import lie, pnp
from openimucameracalibrator_torch.utils import precision
from openimucameracalibrator_torch.utils.types import (CameraCalibration, CornerDataset,
                                                       PoseDataset)


@dataclasses.dataclass
class PoseEstimatorOptions:
    min_num_points: int = 8  # pose_estimator.h:72
    num_hypotheses: int = 128
    refine_iters: int = 15
    # Reprojection inlier threshold as a fraction of image height
    # (pose_estimator.cc:94-101 uses 0.4% of height, normalized).
    ransac_thresh_frac: float = 0.004
    max_view_rmse_px: float = 2.0
    median_z_tol: float = 0.5  # relative deviation allowed (FilterBadPoses)


def _refine_pose_gn(q0, t0, pts3d, xy, w, iters: int):
    """Fixed-iteration damped GN on every view's 6-dof pose.

    q0 (V, 4), t0 (V, 3), pts3d (P, 3), xy (V, P, 2), w (V, P)."""

    def residual(delta, q, t, xy_v, w_v):
        qd = lie.quat_boxplus(q, delta[:3])
        td = t + delta[3:]
        pc = lie.quat_rotate(qd[None], pts3d) + td[None]
        z = torch.clamp(pc[..., 2], min=1e-6)
        r = ((pc[..., :2] / z[..., None] - xy_v) * w_v[..., None]).reshape(-1)
        return r, r

    jac = vmap(jacfwd(residual, has_aux=True))
    q, t = q0, t0
    eye = 1e-8 * torch.eye(6, dtype=t0.dtype, device=t0.device)
    for _ in range(iters):
        J, r = jac(t.new_zeros((t.shape[0], 6)), q, t, xy, w)
        H = J.transpose(-1, -2) @ J + eye
        g = torch.einsum("vri,vr->vi", J, r)
        delta = -torch.linalg.solve(H, g)
        q, t = lie.quat_boxplus(q, delta[:, :3]), t + delta[:, 3:]
    return q, t


def _estimate_all_poses(cam_params, obs, valid, board_pts, uniforms, model_name: str,
                        refine_iters: int, ransac_thresh: float):
    """RANSAC + refinement of every view: (q_cw, t_cw, inlier counts, rmse
    in normalized units). Each step is a ``torch.profiler`` range named
    ``pose_estimator.<step>`` (scripts/profile_torch_pose_init.py reads
    them)."""
    model = cameras.get_model(model_name)
    # Undistort to the normalized image plane (pose_estimator.cc:102-110).
    with record_function("pose_estimator.undistort"):
        bearings = model.unproject(cam_params, obs)
        z = torch.clamp(bearings[..., 2], min=1e-6)
        xy = bearings[..., :2] / z[..., None]
    # Boards are planar: homography-decomposition hypotheses (the 3D DLT
    # is degenerate for coplanar points).
    with record_function("pose_estimator.ransac"):
        q, t, inl, cnt = pnp._ransac_pnp_planar(board_pts, xy, valid, uniforms,
                                                inlier_thresh=ransac_thresh)
    with record_function("pose_estimator.gauss_newton"):
        w = (inl & valid).to(xy.dtype)
        q, t = _refine_pose_gn(q, t, board_pts, xy, w, refine_iters)
    # Final per-view reprojection error on inliers (normalized units).
    with record_function("pose_estimator.rmse"):
        pc = lie.quat_rotate(q[:, None], board_pts) + t[:, None]
        zz = torch.clamp(pc[..., 2], min=1e-6)
        err2 = torch.sum((pc[..., :2] / zz[..., None] - xy) ** 2, -1)
        rmse = torch.sqrt(torch.sum(err2 * w, -1) / torch.clamp(torch.sum(w, -1), min=1.0))
    return q, t, cnt, rmse


def estimate_poses(dataset: CornerDataset, calib: CameraCalibration,
                   options: PoseEstimatorOptions | None = None,
                   seed: int = 0, device=None) -> PoseDataset:
    """Estimate camera-to-world poses for every frame on ``device`` (default
    ``"cuda"``; raises where no CUDA device is present unless
    ``device="cpu"``). Returns PoseDataset (invalid frames flagged, not
    dropped)."""
    opts = options or PoseEstimatorOptions()
    device = precision.resolve_device(device)
    dt = precision.default_dtype(device)
    model = cameras.get_model(calib.model_name)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt, device=device)

    cam_params = T(calib.params)
    obs = T(dataset.points2d)
    valid = torch.as_tensor(np.asarray(dataset.valid, bool), device=device)
    board_pts = T(dataset.board_points)
    w, h = dataset.image_size
    # Normalized-plane threshold: fraction of image height / focal
    # (pose_estimator.cc:94-101).
    focal = float(np.asarray(calib.params)[model.param_groups["focal"][0]])
    thresh = opts.ransac_thresh_frac * h / focal

    gen = torch.Generator(device=device).manual_seed(seed)
    V, P = valid.shape
    uniforms = torch.rand((V, opts.num_hypotheses, P), generator=gen, dtype=dt, device=device)
    q_cw, t_cw, counts, rmse = _estimate_all_poses(cam_params, obs, valid, board_pts, uniforms,
                                                   model.name, opts.refine_iters, thresh)

    counts = counts.cpu().numpy()
    rmse_px = rmse.cpu().numpy().astype(np.float64) * focal
    ok = (counts >= opts.min_num_points) & (rmse_px < opts.max_view_rmse_px)

    # Median-z filter on camera height above the board plane
    # (pose_estimator.cc:238-261): reject poses whose distance to the board
    # deviates grossly from the median.
    q_wc, t_wc = lie.se3_inverse(q_cw, t_cw)
    q_wc = q_wc.cpu().numpy().astype(np.float64)
    t_wc = t_wc.cpu().numpy().astype(np.float64)
    if ok.any():
        med = np.median(t_wc[ok, 2])
        dev = np.abs(t_wc[:, 2] - med)
        ok &= dev < np.maximum(opts.median_z_tol * abs(med), 0.3)

    return PoseDataset(times=np.asarray(dataset.times), q_w_c=q_wc, t_w_c=t_wc, valid=ok,
                       board_points=np.asarray(dataset.board_points))


# ---------------------------------------------------------------------------
# Board-point refinement with empirical covariance
# (reference OptimizeBoardPoints, src/core/pose_estimator.cc:193-224)
# ---------------------------------------------------------------------------

def _optimize_points(cam_params, obs, valid, board_pts, q_cw, t_cw, pose_valid,
                     model_name: str, iters: int = 10):
    """Refine each board point independently with all poses fixed.

    Points are conditionally independent given poses, so this is a batch
    of (3,3) GN solves over the points. Returns (points (P,3), cov (P,3,3),
    reproj_cov (P,2,2)): parameter covariance from sigma^2 (J^T J)^-1 and
    the empirical image-space residual covariance per point.
    """
    model = cameras.get_model(model_name)
    w_all = (valid & pose_valid[:, None]).to(obs.dtype)  # (V, P)

    def point_residual(pt, uv_v, w_v):
        pc = lie.quat_rotate(q_cw, pt[None]) + t_cw
        uv_pred, ok = model.project(cam_params, pc)
        r = ((uv_pred - uv_v) * (w_v * ok.to(uv_pred.dtype))[:, None]).reshape(-1)
        return r, r

    jac = vmap(jacfwd(point_residual, has_aux=True), in_dims=(0, 1, 1))
    eye = torch.eye(3, dtype=obs.dtype, device=obs.device)
    pt = board_pts
    for _ in range(iters):
        J, r = jac(pt, obs, w_all)
        H = J.transpose(-1, -2) @ J + 1e-6 * eye
        # Keep points near the board plane (the reference uses a
        # homogeneous parametrization + pose prior; a soft z clamp is
        # equivalent regularization for planar targets).
        pt = pt - torch.linalg.solve(H, torch.einsum("pri,pr->pi", J, r))
    J, r = jac(pt, obs, w_all)
    H = J.transpose(-1, -2) @ J
    n_obs = torch.clamp(torch.sum(w_all, 0), min=1.0)
    dof = torch.clamp(2.0 * n_obs - 3.0, min=1.0)
    sigma2 = torch.sum(r * r, -1) / dof
    cov = sigma2[:, None, None] * torch.linalg.inv(H + 1e-9 * eye)
    # Empirical 2x2 image-residual covariance of each corner.
    r2 = r.reshape(r.shape[0], -1, 2)
    rc = (r2.transpose(-1, -2) @ r2) / n_obs[:, None, None]
    return pt, cov, rc


def optimize_board_points(dataset: CornerDataset, calib: CameraCalibration,
                          poses: PoseDataset, iters: int = 10, min_obs: int = 30,
                          device=None):
    """Refine board 3D points against all estimated poses and report their
    empirical covariance (OptimizeBoardPoints, pose_estimator.cc:193-224;
    ``min_num_obs_for_optim_=30`` pose_estimator.h:78), on ``device``
    (default ``"cuda"``).

    Returns (PoseDataset with refined board_points, info dict with
    point_cov (P,3,3), reproj_cov (P,2,2), std_mm per point).
    """
    device = precision.resolve_device(device)
    dt = precision.default_dtype(device)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt, device=device)

    obs_count = (dataset.valid & poses.valid[:, None]).sum(axis=0)  # (P,)
    q_cw, t_cw = lie.se3_inverse(T(poses.q_w_c), T(poses.t_w_c))
    pts, cov, rcov = _optimize_points(
        T(calib.params), T(dataset.points2d),
        torch.as_tensor(np.asarray(dataset.valid, bool), device=device), T(poses.board_points),
        q_cw, t_cw, torch.as_tensor(np.asarray(poses.valid, bool), device=device),
        calib.model_name, iters)

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    pts, cov, rcov = host(pts), host(cov), host(rcov)
    # Only trust refinement where the corner was observed enough.
    keep = np.asarray(obs_count) >= min_obs
    new_pts = np.where(keep[:, None], pts, np.asarray(poses.board_points))
    std_mm = np.sqrt(np.maximum(np.trace(cov, axis1=1, axis2=2), 0.0) / 3.0) * 1e3
    info = {"point_cov": cov, "reproj_cov": rcov, "std_mm": std_mm, "refined": keep}
    return dataclasses.replace(poses, board_points=new_pts), info
