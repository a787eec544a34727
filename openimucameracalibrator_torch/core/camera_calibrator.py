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
board points. ``calibrate_camera_batch`` runs N (model, dataset) jobs
through one lane-batched three-stage BA (``lm.lm_optimize_lanes``).

Departures from the JAX package, both in the reference's (Ceres') sense:

* An LM trial that turns invalid an observation which was valid at the
  linearization point fails (``_guard_lost_observations``), as a Ceres
  step fails when a cost functor returns ``false``. In the JAX package an
  invalid projection leaves the cost instead, so a step that makes every
  projection invalid costs 0 and is taken (the double sphere in float32
  walks there, xi driven far negative).
* The stage-1 multi-start keeps the start with the most observations in
  the cost, and of those the lowest cost (``_pick_start``); a calibration
  left with no valid observation raises ``ValueError`` instead of
  reporting 0 px. Where no trial turns an observation invalid and every
  start ends with the same observations, the answer is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.ops import lie, pnp
from openimucameracalibrator_torch.solver import blocks, lm, robust
from openimucameracalibrator_torch.utils import convert, precision
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


def _observation_terms(projected, obs, valid, view_w):
    """(whitened residuals flattened over (view, point, xy), the mask of the
    observations in the cost: detected, validly projected, of an active
    view) from the projection ``(uv, ok)``."""
    uv, ok = projected
    good = valid & ok
    w = good.to(uv.dtype) * view_w[:, None]
    return ((uv - obs) * w[..., None]).reshape(-1), good & (view_w[:, None] > 0)


def _make_residual_fn(model: cameras.CameraModel, obs, valid):
    """Whitened reprojection residuals, flattened over (view, point, xy)."""

    def residual(params, view_w):
        return _observation_terms(_project(model, params), obs, valid, view_w)[0]

    return residual


def _huber(r):
    return robust.huber_sqrt_weights(r, HUBER_PX, group_size=2)


def _guard_lost_observations(linearize_fn, terms_fn):
    """(linearize_fn, cost_fn, state) of an LM solve in which a trial that
    turns invalid an observation valid at the linearization point costs
    NaN, which the LM rejects on the finiteness it already reads (no
    further host read). ``terms_fn(params) -> (residuals (..., M), mask
    (..., V, P))`` as ``_observation_terms``, a leading dim being lanes;
    the cost is the Huber cost of ``lm.make_dense_linearizer``.
    ``state["lost"]`` counts the failed trials on the device (None before
    the first)."""
    state = {"ref": None, "lost": None}

    def linearize(params):
        state["ref"] = terms_fn(params)[1]
        return linearize_fn(params)

    def cost(params):
        r, good = terms_fn(params)
        rw = r * _huber(r)
        c = 0.5 * torch.sum(rw * rw, dim=-1)
        if state["ref"] is None:
            return c
        lost = torch.any((state["ref"] & ~good).flatten(c.ndim), dim=-1)
        state["lost"] = lost.long() if state["lost"] is None else state["lost"] + lost
        return torch.where(lost, torch.full_like(c, float("nan")), c)

    return linearize, cost, state


def _run_ba_stage(params0, free_mask, view_w, obs, valid, model_name: str, max_iters: int):
    """One LM solve: (``lm.LMResult``, observations in the cost at its end,
    trials failed for losing one), the last two as device tensors."""
    model = cameras.get_model(model_name)
    layout = _build_layout(obs.shape[0], model.num_params, params0["pts"].shape[0])

    def terms(p):
        return _observation_terms(_project(model, p), obs, valid, view_w)

    lin, _, retract = lm.make_dense_linearizer(lambda p: terms(p)[0], layout,
                                               weight_fn=_huber)
    lin, cost, state = _guard_lost_observations(lin, terms)
    res = lm.lm_optimize(lin, cost, retract, params0, free_mask,
                         lm.LMConfig(max_iters=max_iters, ftol=1e-8))
    lost = state["lost"]
    if lost is None:
        lost = torch.zeros((), dtype=torch.long, device=res.cost.device)
    return res, terms(res.params)[1].sum(), lost


def _pick_start(costs, n_valid, what: str) -> int:
    """The stage-1 start to keep: of the starts with a finite cost (any,
    where none has one), those with the most observations in the cost, and
    of them the lowest cost, the first on a tie. A start that ends with
    fewer valid observations than another never wins on cost. Raises
    ``ValueError`` where the kept start has no valid observation."""
    costs, n = np.asarray(costs, np.float64), np.asarray(n_valid, np.int64)
    finite = np.isfinite(costs)
    best = min(range(costs.size),
               key=lambda i: (not finite[i], -n[i], costs[i] if finite[i] else 0.0))
    if n[best] == 0:
        raise ValueError(f"{what}: no valid observation; every projection is invalid under "
                         f"each of the {costs.size} stage-1 start(s)")
    return best


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
    holds one record per LM solve: its ``stage`` (1 for each multi-start
    solve, ``xi0`` its start's xi, None for a model without one),
    iterations, status, host seconds, final cost, ``valid_obs`` (the
    observations in the cost at its end), ``lost_valid_trials`` (trials
    failed for turning one invalid) and whether its answer was kept
    (``chosen``); ``details["init_seconds"]`` the host seconds of the
    initialization and view deduplication. Raises ``ValueError`` where no
    observation stays valid.
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

    def stage(k, params, mask, view_w, xi0=None):
        with record_function(f"camera_calibrator.stage{k}"):
            res, n_valid, lost = _run_ba_stage(params, mask, view_w, obs, valid, model.name,
                                               opts.max_iters)
            cost, n_valid, lost = torch.stack(
                [res.cost.double(), n_valid.double(), lost.double()]).tolist()
        stages.append({"stage": k, "xi0": xi0, "iterations": int(res.iterations),
                       "seconds": res.seconds, "status": lm.STATUS_NAMES[res.status],
                       "cost": cost, "valid_obs": int(n_valid), "lost_valid_trials": int(lost),
                       "chosen": True})
        return res.params, int(res.iterations)

    # Stage 1: focal + distortion + poses (camera_calibrator.cc:146-162).
    # Double-sphere multi-start: seed xi in {-0.25, 0, +0.25} with the focal
    # rescaled to keep f/(1+xi) fixed; keep the start ``_pick_start`` picks.
    mask1 = free_mask(fixed=["pts"],
                      partial_masks={"cam": cam_mask(groups["focal"] + groups["dist"])})
    multistart = model.name == "double_sphere"
    starts = [(float(cam0[4]) if multistart else None, params)]
    if multistart:
        for xi0 in (-0.25, 0.25):
            cam_alt = cam0.clone()
            cam_alt[4] = xi0
            cam_alt[0] = cam0[0] * (1 + xi0)
            cam_alt[1] = cam0[1] * (1 + xi0)
            starts.append((xi0, dict(params, cam=cam_alt)))
    with record_function("camera_calibrator.multistart"):
        outs = [stage(1, cand, mask1, view_w, xi0) for xi0, cand in starts]
    ends = stages[-len(starts):]
    k = _pick_start([e["cost"] for e in ends], [e["valid_obs"] for e in ends],
                    f"{model.name} calibration of {picked.size} views")
    for i, e in enumerate(ends):
        e["chosen"] = i == k
    params, it1 = outs[k]
    rmse, _ = _per_view_rmse(params, obs, valid, model.name)
    view_w = view_w * (rmse < opts.stage1_prune_px)

    # Stage 2: principal point only (camera_calibrator.cc:164-174).
    mask2 = free_mask(fixed=["q_cw", "t_cw", "pts"],
                      partial_masks={"cam": cam_mask(groups["pp"])})
    params, it2 = stage(2, params, mask2, view_w)

    # Stage 3: all intrinsics + poses, prune > 2 px (camera_calibrator.cc:181-201).
    mask3 = free_mask(fixed=["pts"])
    params, it3 = stage(3, params, mask3, view_w)
    rmse, _ = _per_view_rmse(params, obs, valid, model.name)
    view_w = view_w * (rmse < opts.stage3_prune_px)
    params, it4 = stage(3, params, mask3, view_w)

    if opts.optimize_board_points:
        # Stage 4: free the board points too; anchor the gauge by keeping
        # the first two corners fixed.
        pts_mask = np.ones((board_pts.shape[0], 3))
        pts_mask[:2] = 0.0
        mask4 = free_mask(partial_masks={"pts": pts_mask})
        params, _ = stage(4, params, mask4, view_w)
    if stages[-1]["valid_obs"] == 0:
        raise ValueError(f"{model.name} calibration: no valid observation left in the "
                         f"{int(torch.count_nonzero(view_w))} active of {picked.size} views")

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


# ---------------------------------------------------------------------------
# Multi-model batched calibration (BASELINE configs[1])
#
# N (model, dataset) pairs run through ONE lane-batched 3-stage BA: camera
# parameter vectors are padded to a common width, the projection evaluates
# every distinct model present and picks each lane's (what the JAX
# package's vmapped lax.switch computes), and every LM stage runs all
# lanes at once (lm.lm_optimize_lanes) -- per-lane free masks carry both
# the model's parameter-group structure and the padding. Model lanes that
# need multi-start (double sphere) become extra lanes, reduced after
# stage 1. The reference has no such mode (one CameraCalibrator per run).
# ---------------------------------------------------------------------------

def _switch_project(model_names: tuple):
    """project(mid, cam_padded, p_cam): each model of ``model_names`` on
    its own leading parameters, the one at index ``mid`` selected. Under
    ``torch.func`` the unselected models' values and tangents are dropped
    by the selection, as under the JAX package's vmapped switch."""
    models = [cameras.get_model(n) for n in model_names]

    def project(mid, cam_padded, p_cam):
        uv, ok = models[0].project(cam_padded[:models[0].num_params], p_cam)
        for i, m in enumerate(models[1:], 1):
            uv_i, ok_i = m.project(cam_padded[:m.num_params], p_cam)
            sel = mid == i
            uv, ok = torch.where(sel, uv_i, uv), torch.where(sel, ok_i, ok)
        return uv, ok

    return project


def _lane_project(project, prm, mid):
    p_cam = (lie.quat_rotate(prm["q_cw"][:, None, :], prm["pts"][None])
             + prm["t_cw"][:, None, :])
    return project(mid, prm["cam"], p_cam)


def _run_ba_stage_multi(params_b, mask_b, view_w_b, obs_b, valid_b, mid_b,
                        model_names: tuple, max_iters: int):
    """One LM stage on every lane at once, each lane guarded as
    ``_run_ba_stage``: (``lm.LMResult`` with per-lane cost, iterations and
    status; observations in the cost at its end per lane (L,))."""
    from torch.func import vmap

    npad = params_b["cam"].shape[-1]
    layout = _build_layout(obs_b.shape[1], npad, params_b["pts"].shape[1])
    project = _switch_project(model_names)

    def lane_terms(prm, view_w, obs, valid, mid):
        return _observation_terms(_lane_project(project, prm, mid), obs, valid, view_w)

    def lane_lin(prm, *d):
        return lm.make_dense_linearizer(lambda p: lane_terms(p, *d)[0], layout,
                                        weight_fn=_huber)[0](prm)

    data = (view_w_b, obs_b, valid_b, mid_b)
    terms_b = vmap(lane_terms)
    lin_b = vmap(lane_lin)
    lin, cost, _ = _guard_lost_observations(lambda prm: lin_b(prm, *data),
                                            lambda prm: terms_b(prm, *data))
    res = lm.lm_optimize_lanes(lin, cost, vmap(layout.retract), params_b, mask_b,
                               lm.LMConfig(max_iters=max_iters, ftol=1e-8))
    return res, terms_b(res.params, *data)[1].sum((1, 2))


def _per_view_rmse_multi(params_b, obs_b, valid_b, mid_b, model_names: tuple):
    """(per-view RMSE (L, V), per-observation error (L, V, P), good mask)."""
    from torch.func import vmap

    project = _switch_project(model_names)

    def one(prm, obs, valid, mid):
        uv, ok = _lane_project(project, prm, mid)
        good = valid & ok
        err2 = torch.sum((uv - obs) ** 2, -1) * good
        n = torch.clamp(torch.sum(good, -1), min=1)
        err = torch.linalg.vector_norm(uv - obs, dim=-1) * good
        return torch.sqrt(torch.sum(err2, -1) / n), err, good

    return vmap(one)(params_b, obs_b, valid_b, mid_b)


def calibrate_camera_batch(jobs, options: CameraCalibratorOptions | None = None, device=None):
    """Calibrate N (model_name, CornerDataset) pairs in one lane-batched
    solve on ``device`` (default ``"cuda"``).

    Returns a list of (CameraCalibration, details) in input order. All
    datasets must share the image size class (shapes are padded to common
    maxima). Host-side init (homography/focal, voxel dedup) runs per
    dataset; the 3-stage BA schedule runs on all lanes at once.
    """
    opts = options or CameraCalibratorOptions()
    device = precision.resolve_device(device)
    dt = precision.resolve(opts.dtype, device)

    # --- host-side per-dataset init (same path as calibrate_camera) ---
    lanes = []
    for ji, (model_name, dataset) in enumerate(jobs):
        model = cameras.get_model(model_name)
        w, h = dataset.image_size
        f0, q_cw, t_cw, enough, lam0 = initialize_views(
            dataset, dt, distortion_aware=(model.name != "pinhole"), device=device)
        rot = lie.quat_to_matrix(torch.as_tensor(q_cw, dtype=torch.float64)).numpy()
        cam_pos = np.einsum("vij,vj->vi", np.transpose(rot, (0, 2, 1)), -t_cw)
        picked = _voxel_dedup(cam_pos, enough, opts.grid_size, opts.max_views)
        grid = opts.grid_size
        while picked.size < opts.min_num_views and grid > 1e-6 and \
                picked.size < int(np.sum(enough)):
            grid *= 0.5
            picked = _voxel_dedup(cam_pos, enough, grid, opts.max_views)
        if picked.size < opts.min_num_views:
            raise ValueError(f"job {ji} ({model_name}): only {picked.size} "
                             f"usable views (need >= {opts.min_num_views})")
        cam0 = model.init_params(f0, w / 2.0, h / 2.0, dtype=dt, device="cpu").numpy()
        if model.name == "division_undistortion":
            cam0[3] = lam0
        base = dict(job=ji, model=model, picked=picked, f0=f0,
                    obs=np.asarray(dataset.points2d[picked], np.float64),
                    valid=np.asarray(dataset.valid[picked]),
                    pts=np.asarray(dataset.board_points, np.float64),
                    q_cw=q_cw[picked], t_cw=t_cw[picked])
        lanes.append(dict(base, cam=cam0, alt=False))
        if model.name == "double_sphere":
            for xi0 in (-0.25, 0.25):
                cam_alt = cam0.copy()
                cam_alt[4] = xi0
                cam_alt[0] = float(cam0[0]) * (1 + xi0)
                cam_alt[1] = float(cam0[1]) * (1 + xi0)
                lanes.append(dict(base, cam=cam_alt, alt=True))

    model_names = tuple(dict.fromkeys(ln["model"].name for ln in lanes))
    npad = max(cameras.get_model(n).num_params for n in model_names)
    v_max = max(ln["obs"].shape[0] for ln in lanes)
    p_max = max(ln["pts"].shape[0] for ln in lanes)
    L = len(lanes)

    obs_b = np.zeros((L, v_max, p_max, 2))
    valid_b = np.zeros((L, v_max, p_max), bool)
    params_b = {"cam": np.zeros((L, npad)), "q_cw": np.zeros((L, v_max, 4)),
                "t_cw": np.zeros((L, v_max, 3)), "pts": np.zeros((L, p_max, 3))}
    params_b["q_cw"][..., 0] = 1.0  # padded views: identity quats
    view_w_b = np.zeros((L, v_max))
    mid_b = np.zeros((L,), np.int64)
    layout = _build_layout(v_max, npad, p_max)
    masks = np.zeros((3, L, layout.tangent_dim))
    for i, ln in enumerate(lanes):
        m = ln["model"]
        V, P = ln["obs"].shape[:2]
        obs_b[i, :V, :P] = ln["obs"]
        valid_b[i, :V, :P] = ln["valid"]
        params_b["cam"][i, :m.num_params] = ln["cam"]
        params_b["q_cw"][i, :V] = ln["q_cw"]
        params_b["t_cw"][i, :V] = ln["t_cw"]
        params_b["pts"][i, :P] = ln["pts"]
        view_w_b[i, :V] = 1.0
        mid_b[i] = model_names.index(m.name)

        def cam_mask(free_idx):
            c = np.zeros(npad)
            c[np.asarray(free_idx, int)] = 1.0
            return c

        pose_mask = np.zeros((v_max, 3))
        pose_mask[:V] = 1.0
        g = m.param_groups
        masks[0, i] = layout.free_mask(
            fixed=["pts"], partial_masks={"cam": cam_mask(g["focal"] + g["dist"]),
                                          "q_cw": pose_mask, "t_cw": pose_mask}).numpy()
        masks[1, i] = layout.free_mask(
            fixed=["q_cw", "t_cw", "pts"], partial_masks={"cam": cam_mask(g["pp"])}).numpy()
        masks[2, i] = layout.free_mask(
            fixed=["pts"], partial_masks={"cam": cam_mask(range(m.num_params)),
                                          "q_cw": pose_mask, "t_cw": pose_mask}).numpy()

    def T(x):
        return torch.as_tensor(x, dtype=dt, device=device)

    prm = convert.ba_params_from_numpy(params_b, device=device, dtype=dt)
    obs_t, vw = T(obs_b), T(view_w_b)
    valid_t = torch.as_tensor(valid_b, device=device)
    mid_t = torch.as_tensor(mid_b, device=device)
    m1, m2, m3 = (T(m) for m in masks)

    def stage(prm, mask, vw):
        return _run_ba_stage_multi(prm, mask, vw, obs_t, valid_t, mid_t, model_names,
                                   opts.max_iters)

    # Stage 1 (+ multi-start reduction, the rule of calibrate_camera).
    res, n_valid = stage(prm, m1, vw)
    costs, n_valid = res.cost.double().cpu().numpy(), n_valid.cpu().numpy()
    keep = []
    for ji, (model_name, _) in enumerate(jobs):
        idxs = [i for i, ln in enumerate(lanes) if ln["job"] == ji]
        k = _pick_start(costs[idxs], n_valid[idxs], f"job {ji} ({model_name})")
        keep.append(idxs[k])
    sel = torch.as_tensor(keep, device=device)
    prm = {k: v[sel] for k, v in res.params.items()}
    vw, obs_t, valid_t, mid_t = vw[sel], obs_t[sel], valid_t[sel], mid_t[sel]
    m2, m3 = m2[sel], m3[sel]

    rmse, _, _ = _per_view_rmse_multi(prm, obs_t, valid_t, mid_t, model_names)
    vw = vw * (rmse < opts.stage1_prune_px)
    prm = stage(prm, m2, vw)[0].params
    prm = stage(prm, m3, vw)[0].params
    rmse, _, _ = _per_view_rmse_multi(prm, obs_t, valid_t, mid_t, model_names)
    vw = vw * (rmse < opts.stage3_prune_px)
    prm = stage(prm, m3, vw)[0].params

    rmse, err, good = _per_view_rmse_multi(prm, obs_t, valid_t, mid_t, model_names)
    host = convert.ba_params_to_numpy(prm)
    err_np, good_np = err.cpu().numpy(), good.cpu().numpy()
    vw_np, rmse_np = vw.cpu().numpy(), rmse.cpu().numpy().astype(np.float64)
    out = []
    for ji, (model_name, dataset) in enumerate(jobs):
        m = cameras.get_model(model_name)
        ln = lanes[keep[ji]]
        V = ln["obs"].shape[0]
        act = (vw_np[ji, :, None] > 0) & good_np[ji]
        if not act.any():
            raise ValueError(f"job {ji} ({model_name}): no valid observation left in the "
                             f"{int(np.count_nonzero(vw_np[ji]))} active of {V} views")
        tot = err_np[ji][act].sum()
        n = int(act.sum())
        calib = CameraCalibration(
            model_name=m.name, params=host["cam"][ji][:m.num_params],
            image_size=dataset.image_size, mean_reproj_error=float(tot / n), fps=dataset.fps)
        details = {"picked_views": ln["picked"], "active": vw_np[ji, :V] > 0,
                   "q_cw": host["q_cw"][ji][:V], "t_cw": host["t_cw"][ji][:V],
                   "per_view_rmse": rmse_np[ji][:V], "init_focal": ln["f0"]}
        out.append((calib, details))
    return out
