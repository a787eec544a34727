"""The double sphere's stage 1 (core/camera_calibrator.py) in float32, and
the rule that keeps an LM step or a multi-start from winning by making
projections invalid.

Without the rule an invalid projection leaves the cost: an LM trial that
turns observations invalid lowers the cost by dropping them, and a step
that makes every projection invalid (xi driven far negative) costs 0, is
accepted and wins the multi-start, reported at 0 px. In float32 the
double-sphere stage 1 walks there on some views of the gopro6_ds5 rig.

* A calibration of 40 views of the benchmark generator's gopro6_ds5
  intrinsics scene recovers the near-axis magnification f / (1 + xi) and
  the principal point; (f, xi, alpha) itself is not held to the truth, as
  over a finite field of view it has near-equivalent families (the
  multi-start may keep f = 616, xi = 0.42 on such views, at the same
  reprojection error).
* A start whose stage-1 solve ends with every projection invalid does not
  win, in ``calibrate_camera`` and in ``calibrate_camera_batch``.
* The LM rejects a trial that turns a valid observation invalid.
* A dataset with no valid projection raises instead of reporting 0 px.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmarks.gen import scene as bench_scene
from openimucameracalibrator_torch.core import camera_calibrator as cc
from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.ops import lie
from openimucameracalibrator_torch.solver import blocks, lm
from openimucameracalibrator_torch.utils import synthetic
from openimucameracalibrator_torch.utils.types import CornerDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS_SMALL = [364.0, 364.5, 480.0, 270.0, -0.2, 0.55]


def _gopro6_ds5_views(num_views, seed):
    with open(os.path.join(ROOT, "benchmarks", "configs", "gopro6_ds5.json")) as f:
        cfg = json.load(f)
    sc = bench_scene.make_intrinsics_scene("double_sphere", cfg["cam_params"],
                                           num_views=num_views,
                                           image_size=tuple(cfg["image_size"]), noise_px=0.2,
                                           seed=seed, device="cpu")
    ds = CornerDataset(sc.frame_times, sc.observations, sc.obs_valid, sc.board_points,
                       sc.image_size, cfg["cam_fps"])
    return ds, np.asarray(cfg["cam_params"], np.float64)


def _small_views():
    """16 views of the port's intrinsics scene (the JAX-parity tests' size)."""
    sc = synthetic.make_intrinsics_scene(cameras.get_model("double_sphere"), DS_SMALL,
                                         num_views=16, seed=3, device="cpu")
    return CornerDataset(sc.frame_times, sc.observations, sc.obs_valid,
                         np.asarray(sc.board.points), sc.image_size, 30.0)


# The selection is what these cases check, so the solves are cut short.
SMALL_OPTS = dict(grid_size=0.01, min_num_views=5, max_iters=6)
BAD_CAM = [-3388.99, -3389.10, 480.0, 270.0, -8.69, -0.10]  # an all-invalid stage-1 end


def test_float32_double_sphere_recovers_the_rig():
    """40 views, float32, the CLI's 0.04 m voxel grid. Bars: f / (1 + xi)
    within 3 % and the principal point within 2.5 px of the truth. The
    views fix the magnification to about 2 %, as the focal length trades
    against the board's distance and xi against alpha: over 24 such scenes
    (0.2 px noise, 21-34 views kept) the port read it within 1.2 % and the
    principal point within 1.3 px, and on the cell's 300-view scenes
    within 1.9 % and 1.3 px (float32, on the card and the CPU). An answer
    that drops observations is caught by the valid share and the error,
    not by these bars. On this scene stage 1 without the rule ended at
    f = -170.5, xi = -1.39 and 0 px (float32, two CPU threads)."""
    ds, truth = _gopro6_ds5_views(40, seed=17)
    calib, det = cc.calibrate_camera(ds, "DOUBLE_SPHERE",
                                     cc.CameraCalibratorOptions(dtype=torch.float32),
                                     device="cpu")
    p = np.asarray(calib.params, np.float64)
    mag, mag_true = p[0] / (1 + p[4]), truth[0] / (1 + truth[4])
    assert abs(mag - mag_true) / mag_true < 0.03
    np.testing.assert_allclose(p[2:4], truth[2:4], rtol=0, atol=2.5)
    assert calib.mean_reproj_error > 0.1
    # The observations of the kept views that the answer projects validly.
    picked = det["picked_views"]
    valid = np.asarray(ds.valid)[picked]
    q = torch.as_tensor(det["q_cw"])
    t = torch.as_tensor(det["t_cw"])
    pts = torch.as_tensor(det["board_points"])
    p_cam = lie.quat_rotate(q[:, None, :], pts[None]) + t[:, None, :]
    _, ok = cameras.get_model("double_sphere").project(torch.as_tensor(p), p_cam)
    assert (ok.numpy() & valid).sum() > 0.95 * valid.sum()
    assert det["lm_stages"][-1]["valid_obs"] > 0.95 * valid.sum()
    assert sum(s["chosen"] for s in det["lm_stages"] if s["stage"] == 1) == 1


def _degenerate_third_start(real, counter):
    """``_run_ba_stage`` whose third stage-1 solve (xi0 = +0.25) ends as an
    unguarded LM would: every projection invalid, cost 0."""
    def wrapper(params0, free_mask, view_w, *a, **kw):
        res, n_valid, lost = real(params0, free_mask, view_w, *a, **kw)
        counter.append(1)
        if len(counter) == 3:
            cam = torch.tensor(BAD_CAM, dtype=res.cost.dtype)
            res = res._replace(params=dict(res.params, cam=cam), cost=torch.zeros_like(res.cost))
            n_valid = torch.zeros_like(n_valid)
        return res, n_valid, lost
    return wrapper


def test_an_all_invalid_start_does_not_win(monkeypatch):
    ds = _small_views()
    opts = cc.CameraCalibratorOptions(**SMALL_OPTS)
    monkeypatch.setattr(cc, "_run_ba_stage", _degenerate_third_start(cc._run_ba_stage, []))
    calib, det = cc.calibrate_camera(ds, "double_sphere", opts, device="cpu")
    first = [s for s in det["lm_stages"] if s["stage"] == 1]
    assert [s["xi0"] for s in first] == [0.0, -0.25, 0.25]
    assert first[2]["cost"] == 0.0 and first[2]["valid_obs"] == 0 and not first[2]["chosen"]
    assert [s["chosen"] for s in first].count(True) == 1
    assert calib.params[0] > 0 and calib.mean_reproj_error > 0


@pytest.mark.parametrize("costs,n_valid,kept", [
    ([95.1, 0.0, 95.2], [2394, 0, 2394], 0),        # all-invalid at cost 0
    ([95.1, 90.0, 95.0], [2394, 2393, 2394], 2),    # one observation fewer, lower cost
    ([float("nan"), 95.3, 95.3], [2394, 2394, 2394], 1),  # NaN, then a tie: the first
])
def test_the_start_rule(costs, n_valid, kept):
    assert cc._pick_start(costs, n_valid, "case") == kept


def test_an_all_invalid_lane_does_not_win_the_batch(monkeypatch):
    """The batched path: the double sphere's +0.25 lane (lane 2 of the
    job's three) ends all-invalid at cost 0 and is not kept. Were it kept,
    stages 2-3 would start from it and the job would raise."""
    ds = _small_views()
    real = cc._run_ba_stage_multi
    calls = []

    def wrapper(params_b, *a, **kw):
        res, n_valid = real(params_b, *a, **kw)
        calls.append(1)
        if len(calls) == 1:
            cam = res.params["cam"].clone()
            cam[2] = torch.tensor(BAD_CAM, dtype=cam.dtype)
            res = res._replace(params=dict(res.params, cam=cam),
                               cost=torch.where(torch.arange(3) == 2, 0.0, res.cost))
            n_valid = torch.where(torch.arange(3) == 2, 0, n_valid)
        return res, n_valid

    monkeypatch.setattr(cc, "_run_ba_stage_multi", wrapper)
    [(calib, det)] = cc.calibrate_camera_batch([("double_sphere", ds)],
                                               cc.CameraCalibratorOptions(**SMALL_OPTS),
                                               device="cpu")
    assert calib.params[0] > 0 and calib.mean_reproj_error > 0


def test_the_lm_rejects_a_trial_that_loses_a_valid_observation():
    """Two residuals pulling x toward 1.5, one observation that is valid
    only while x[0] < 1. From 0 the first Gauss-Newton step lands near
    1.5, where the observation is invalid: unguarded that costs 0 and is
    taken; the stage LM's guarded cost fails it, and a more damped retry
    stops short of the boundary."""
    layout = blocks.BlockLayout([blocks.BlockSpec("x", (2,))])

    def terms(p):
        good = (p["x"][0] < 1.0).reshape(1, 1)
        return (p["x"] - 1.5) * good[0, 0], good

    lin, cost, _ = lm.make_dense_linearizer(lambda p: terms(p)[0], layout, weight_fn=cc._huber)
    x0 = {"x": torch.zeros(2, dtype=torch.float64)}
    mask = torch.ones(2, dtype=torch.float64)
    cfg = lm.LMConfig(max_iters=5, ftol=1e-8)
    loose = lm.lm_optimize(lin, cost, layout.retract, x0, mask, cfg)
    assert float(loose.params["x"][0]) >= 1.0 and float(loose.cost) == 0.0

    g_lin, g_cost, state = cc._guard_lost_observations(lin, terms)
    res = lm.lm_optimize(g_lin, g_cost, layout.retract, x0, mask, cfg)
    assert 0.0 < float(res.params["x"][0]) < 1.0
    assert float(res.cost) > 0.0
    assert int(state["lost"]) > 0


def _nothing_valid(real):
    def wrapper(*a, **kw):
        uv, ok = real(*a, **kw)
        return uv, torch.zeros_like(ok)
    return wrapper


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch"])
def test_no_valid_projection_raises(monkeypatch, batched):
    """Every projection invalid from the start: the calibration raises and
    names it, where the JAX package reports a mean error of 0 px."""
    ds = _small_views()
    opts = cc.CameraCalibratorOptions(**SMALL_OPTS)
    if batched:
        monkeypatch.setattr(cc, "_lane_project", _nothing_valid(cc._lane_project))
        with pytest.raises(ValueError, match="no valid observation"):
            cc.calibrate_camera_batch([("double_sphere", ds)], opts, device="cpu")
    else:
        monkeypatch.setattr(cc, "_project", _nothing_valid(cc._project))
        with pytest.raises(ValueError, match="no valid observation"):
            cc.calibrate_camera(ds, "double_sphere", opts, device="cpu")
