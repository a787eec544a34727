"""Camera intrinsic calibration from board corner observations.

Port of ``core/camera_calibrator.py`` of the JAX package (the reference's
CameraCalibrator, camera_calibrator.cc:131-388):

1. Initialization: all views at once with batched normalized-DLT
   homographies, Zhang's closed-form shared focal and homography pose
   decomposition (``ops/pnp.py``); for distortion models a division-model
   lambda grid is searched first.
2. Voxel-grid view deduplication (camera_calibrator.cc:314-327), halving
   the spacing while too few views survive.
3. Three-stage bundle adjustment with a Huber loss (1.345 px) and view
   pruning: focal + distortion + poses (prune views > 5 px), principal
   point only, everything (prune views > 2 px, then once more); an
   optional stage frees the board points. Each stage is one LM solve
   (``solver/lm.py``, classic loop, Jacobian by ``torch.func.jacfwd``).

Parameters are ``{"cam", "q_cw", "t_cw", "pts"}``: the camera model
vector, per-view camera-from-world quaternions and translations, and the
board points. ``calibrate_camera_batch`` (many models in one solve) comes
in a later slice.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.ops import lie, pnp
from openimucameracalibrator_torch.solver import blocks, lm, robust
from openimucameracalibrator_torch.utils import precision
from openimucameracalibrator_torch.utils.types import CameraCalibration, CornerDataset

HUBER_PX = 1.345  # camera_calibrator.cc:140-144


@dataclasses.dataclass
class CameraCalibratorOptions:
    grid_size: float = 0.04  # voxel dedup spacing, meters (camera_calibrator.h:60)
    min_num_views: int = 10  # camera_calibrator.h:85
    max_views: int = 120  # cap on deduped views
    stage1_prune_px: float = 5.0  # camera_calibrator.cc:162
    stage3_prune_px: float = 2.0  # camera_calibrator.cc:201
    max_iters: int = 40
    # Optional stage 4: refine board points against an imperfect target
    # (camera_calibrator.cc:208-216 "optimize_board_points").
    optimize_board_points: bool = False
    dtype: torch.dtype | None = None


def _build_layout(num_views: int, num_cam_params: int, num_points: int):
    return blocks.BlockLayout([
        blocks.BlockSpec("cam", (num_cam_params,)),
        blocks.BlockSpec("q_cw", (num_views, 4), "quat"),
        blocks.BlockSpec("t_cw", (num_views, 3)),
        blocks.BlockSpec("pts", (num_points, 3)),
    ])


def _project(model, params):
    p_cam = (lie.quat_rotate(params["q_cw"][:, None, :], params["pts"][None])
             + params["t_cw"][:, None, :])
    return model.project(params["cam"], p_cam)


def _make_residual_fn(model: cameras.CameraModel, obs, valid, px_scale=1.0):
    """Whitened reprojection residuals, flattened over (view, point, xy)."""

    def residual(params, view_w):
        uv, ok = _project(model, params)
        w = (valid & ok).to(uv.dtype) * view_w[:, None]
        r = (uv - obs) * w[..., None] * px_scale
        return r.reshape(-1)

    return residual


def _run_ba_stage(params0, free_mask, view_w, obs, valid, model_name: str, max_iters: int):
    """One LM solve; returns the ``lm.LMResult``."""
    model = cameras.get_model(model_name)
    layout = _build_layout(obs.shape[0], model.num_params, params0["pts"].shape[0])
    residual = _make_residual_fn(model, obs, valid)

    def wfn(r):
        return robust.huber_sqrt_weights(r, HUBER_PX, group_size=2)

    lin, cost, retract = lm.make_dense_linearizer(lambda p: residual(p, view_w), layout,
                                                  weight_fn=wfn)
    return lm.lm_optimize(lin, cost, retract, params0, free_mask,
                          lm.LMConfig(max_iters=max_iters, ftol=1e-8))


def _per_view_rmse(params, obs, valid, model_name: str):
    uv, ok = _project(cameras.get_model(model_name), params)
    good = valid & ok
    err2 = torch.sum((uv - obs) ** 2, -1) * good
    n = torch.clamp(torch.sum(good, -1), min=1)
    return torch.sqrt(torch.sum(err2, -1) / n), good


def mean_reproj_error(params, obs, valid, model_name: str, view_w):
    """Mean per-observation pixel error over active views (the metric the
    reference reports, camera_calibrator.cc:364-368)."""
    uv, ok = _project(cameras.get_model(model_name), params)
    good = valid & ok & (view_w[:, None] > 0)
    err = torch.linalg.vector_norm(uv - obs, dim=-1) * good
    return torch.sum(err) / torch.clamp(torch.sum(good), min=1)


def initialize_views(dataset: CornerDataset, dtype=None, distortion_aware: bool = False,
                     device=None):
    """Batched homography init: shared focal + per-view camera-from-world pose.

    With ``distortion_aware`` a division-model coefficient grid is searched
    first (``pnp.radial_division_init``) and the homographies and focal
    come from the undistorted corners.

    Returns (f0, q_cw, t_cw, enough, lam): numpy poses, the per-view
    ``>= 10 corners`` mask, and the best division coefficient (1/px^2,
    principal-point-centered; 0.0 when not searched).
    """
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)

    def T(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    w, h = dataset.image_size
    cc = T([w / 2.0, h / 2.0])
    obs = T(dataset.points2d)
    valid = torch.as_tensor(np.asarray(dataset.valid), device=device)
    obj = T(dataset.board_points[:, :2]).expand(obs.shape[:1] + (-1, -1))
    mask = valid.to(dtype)
    lam = 0.0
    if distortion_aware:
        # Grid in normalized units lam_n = lam * diag^2 (GoPro-class wide
        # FOV sits near -1: reference d = -1.44e-6 at diag^2 = 1.2e6 px^2).
        diag2 = float(w * w + h * h)
        lam_grid = T(np.linspace(-2.0, 0.5, 26) / diag2)
        lam_b, _, _ = pnp.radial_division_init(obj, obs - cc, mask, lam_grid)
        lam = float(lam_b)
        r2 = torch.sum((obs - cc) ** 2, -1)
        obs_init = cc + (obs - cc) / (1.0 + lam_b * r2)[..., None]
        Hs = pnp.homography_dlt(obj, obs_init - cc, mask)
    else:
        Hs = pnp.homography_dlt(obj, obs - cc, mask)
    enough = torch.sum(valid, -1) >= 10
    f0 = pnp.zhang_focal(Hs, enough)
    V = obs.shape[0]
    q_cw, t_cw = pnp.pose_from_homography(Hs, f0.expand(V), torch.zeros((V, 2), dtype=dtype,
                                                                         device=device))

    def host(x):
        return x.detach().cpu().numpy()

    return float(f0), host(q_cw), host(t_cw), host(enough), lam


def _voxel_dedup(t_wc: np.ndarray, usable: np.ndarray, grid_size: float, max_views: int):
    """Greedy spatial thinning of view positions (camera_calibrator.cc:314-327)."""
    picked = []
    for v in range(t_wc.shape[0]):
        if not usable[v]:
            continue
        if picked and np.min(np.linalg.norm(t_wc[picked] - t_wc[v], axis=-1)) < grid_size:
            continue
        picked.append(v)
        if len(picked) >= max_views:
            break
    return np.asarray(picked, dtype=np.int64)


def calibrate_camera(dataset: CornerDataset, model_name: str,
                     options: CameraCalibratorOptions | None = None, device=None):
    """Full intrinsic calibration on ``device`` (default ``"cuda"``).

    Returns (CameraCalibration, details dict). ``details["lm_stages"]``
    holds each LM solve's iterations, status and host seconds, and
    ``details["init_seconds"]`` the host seconds of the initialization and
    view deduplication.
    """
    opts = options or CameraCalibratorOptions()
    device = precision.resolve_device(device)
    dt = precision.resolve(opts.dtype, device)
    model = cameras.get_model(model_name)
    w, h = dataset.image_size

    def T(x):
        return torch.as_tensor(np.array(x), dtype=dt, device=device)

    t_init = time.perf_counter()
    f0, q_cw, t_cw, enough, lam0 = initialize_views(
        dataset, dt, distortion_aware=(model.name != "pinhole"), device=device)
    # Camera position in world = -R^T t.
    rot = lie.quat_to_matrix(torch.as_tensor(q_cw, dtype=torch.float64)).numpy()
    cam_pos = np.einsum("vij,vj->vi", np.transpose(rot, (0, 2, 1)), -t_cw)
    picked = _voxel_dedup(cam_pos, enough, opts.grid_size, opts.max_views)
    # Adaptive dedup: halve the spacing until enough views survive (the
    # reference hard-fails there, camera_calibrator.h:85).
    grid = opts.grid_size
    while picked.size < opts.min_num_views and grid > 1e-6 and \
            picked.size < int(np.sum(enough)):
        grid *= 0.5
        picked = _voxel_dedup(cam_pos, enough, grid, opts.max_views)
    if grid != opts.grid_size and picked.size >= opts.min_num_views:
        print(f"   [camera_calibrator] voxel grid relaxed "
              f"{opts.grid_size:.4f} -> {grid:.4f} m to keep "
              f"{picked.size} views")
    if picked.size < opts.min_num_views:
        n_corners = np.sum(np.asarray(dataset.valid), -1)
        n_enough = int(np.sum(enough))
        raise ValueError(
            f"only {picked.size} usable views (need >= {opts.min_num_views}): "
            f"{len(n_corners)} frames, {n_enough} with >=10 detected corners "
            f"(per-frame corner counts {n_corners.tolist()}), "
            f"{n_enough - picked.size} removed by voxel dedup at final "
            f"grid {grid:.5f} m (start {opts.grid_size} m). Record more "
            f"viewpoint diversity or lower min_num_views.")

    init_seconds = time.perf_counter() - t_init
    obs = T(dataset.points2d[picked])
    valid = torch.as_tensor(np.asarray(dataset.valid)[picked], device=device)
    board_pts = T(dataset.board_points)

    cam0 = model.init_params(f0, w / 2.0, h / 2.0, dtype=dt, device=device)
    if model.name == "division_undistortion":
        cam0[3] = lam0  # seed d from the radial grid search
    params = {"cam": cam0, "q_cw": T(q_cw[picked]), "t_cw": T(t_cw[picked]), "pts": board_pts}
    layout = _build_layout(picked.size, model.num_params, board_pts.shape[0])
    groups = model.param_groups
    view_w = torch.ones((picked.size,), dtype=dt, device=device)
    stages = []

    def cam_mask(free_idx):
        m = np.zeros(model.num_params)
        m[free_idx] = 1.0
        return m

    def free_mask(**kw):
        return layout.free_mask(**kw, dtype=dt, device=device)

    def stage(params, mask, view_w):
        res = _run_ba_stage(params, mask, view_w, obs, valid, model.name, opts.max_iters)
        stages.append({"iterations": int(res.iterations), "seconds": res.seconds,
                       "status": lm.STATUS_NAMES[res.status]})
        return res.params, res.cost, int(res.iterations)

    # Stage 1: focal + distortion + poses (camera_calibrator.cc:146-162).
    # Double-sphere multi-start: seed xi in {-0.25, 0, +0.25} with the focal
    # rescaled to keep f/(1+xi) fixed; keep the lowest-cost solution.
    mask1 = free_mask(fixed=["pts"],
                      partial_masks={"cam": cam_mask(groups["focal"] + groups["dist"])})
    starts = [params]
    if model.name == "double_sphere":
        for xi0 in (-0.25, 0.25):
            cam_alt = cam0.clone()
            cam_alt[4] = xi0
            cam_alt[0] = cam0[0] * (1 + xi0)
            cam_alt[1] = cam0[1] * (1 + xi0)
            starts.append(dict(params, cam=cam_alt))
    best = None
    for cand in starts:
        out = stage(cand, mask1, view_w)
        # A NaN stage-1 cost must never beat a finite alternative start.
        if (best is None or not np.isfinite(float(best[1]))
                or float(out[1]) < float(best[1])):
            best = out
    params, cost, it1 = best
    rmse, _ = _per_view_rmse(params, obs, valid, model.name)
    view_w = view_w * (rmse < opts.stage1_prune_px)

    # Stage 2: principal point only (camera_calibrator.cc:164-174).
    mask2 = free_mask(fixed=["q_cw", "t_cw", "pts"],
                      partial_masks={"cam": cam_mask(groups["pp"])})
    params, cost, it2 = stage(params, mask2, view_w)

    # Stage 3: all intrinsics + poses, prune > 2 px (camera_calibrator.cc:181-201).
    mask3 = free_mask(fixed=["pts"])
    params, cost, it3 = stage(params, mask3, view_w)
    rmse, _ = _per_view_rmse(params, obs, valid, model.name)
    view_w = view_w * (rmse < opts.stage3_prune_px)
    params, cost, it4 = stage(params, mask3, view_w)

    if opts.optimize_board_points:
        # Stage 4: free the board points too; anchor the gauge by keeping
        # the first two corners fixed.
        pts_mask = np.ones((board_pts.shape[0], 3))
        pts_mask[:2] = 0.0
        mask4 = free_mask(partial_masks={"pts": pts_mask})
        params, cost, _ = stage(params, mask4, view_w)

    rmse, _ = _per_view_rmse(params, obs, valid, model.name)
    active = view_w.cpu().numpy() > 0
    err = float(mean_reproj_error(params, obs, valid, model.name, view_w))

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    calib = CameraCalibration(
        model_name=model.name, params=host(params["cam"]),
        image_size=dataset.image_size, mean_reproj_error=err, fps=dataset.fps)
    details = {
        "picked_views": picked, "active": active,
        "q_cw": host(params["q_cw"]), "t_cw": host(params["t_cw"]),
        "per_view_rmse": host(rmse), "iters": [it1, it2, it3, it4],
        "init_focal": f0, "board_points": host(params["pts"]), "lm_stages": stages,
        "init_seconds": init_seconds,
    }
    return calib, details
