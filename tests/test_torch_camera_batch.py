"""The port's multi-model batched camera calibration against the JAX
package's and against the port's own per-job ``calibrate_camera``, on the
CPU in float64.

Three tiny jobs of different models (pinhole, division-undistortion,
double sphere with its two extra multi-start lanes) from the JAX
intrinsics scene, 12 views each. Tolerances: camera parameters and poses
to 1e-6 relative, mean reprojection error to 1e-6 relative, the same
picked and active views (as ``test_torch_intrinsics`` holds
``calibrate_camera``). The lane-batched LM loop is held to the unbatched
loop lane by lane: the same iterations and statuses, costs and parameters
to 1e-9 relative (batched products sum in another order than the
unbatched ones, and the differences carry from iteration to iteration).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_tpu.core import camera_calibrator as j_cc
from openimucameracalibrator_tpu.models import cameras as j_cameras
from openimucameracalibrator_tpu.utils import synthetic as j_synthetic
from openimucameracalibrator_tpu.utils import types as j_types
from openimucameracalibrator_torch.core import camera_calibrator as t_cc
from openimucameracalibrator_torch.solver import blocks, lm
from openimucameracalibrator_torch.utils import types as t_types

TRUE_PARAMS = {
    "pinhole": [437.0, 437.5, 481.0, 271.5],
    "division_undistortion": [437.13, 489.07, 270.87, -1.4386e-06],
    "double_sphere": [364.0, 364.5, 480.0, 270.0, -0.2, 0.55],
}
OPTS = dict(grid_size=0.01, min_num_views=5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def jobs():
    out = []
    for i, (name, p) in enumerate(TRUE_PARAMS.items()):
        sc = j_synthetic.make_intrinsics_scene(j_cameras.get_model(name), jnp.array(p),
                                               num_views=12, seed=3 + i)
        out.append((name, dict(times=np.asarray(sc.frame_times),
                               points2d=np.array(sc.observations), valid=np.array(sc.obs_valid),
                               board_points=np.array(sc.board.points),
                               image_size=sc.image_size, fps=30.0)))
    return out


@pytest.fixture(scope="module")
def port_batch(jobs):
    return t_cc.calibrate_camera_batch([(n, t_types.CornerDataset(**d)) for n, d in jobs],
                                       t_cc.CameraCalibratorOptions(**OPTS), device="cpu")


def _same(got, want):
    (cg, dg), (cw, dw) = got, want
    assert cg.model_name == cw.model_name
    assert cg.params.shape == np.asarray(cw.params).shape
    assert _rel(cg.params, cw.params) < 1e-6
    assert cg.mean_reproj_error == pytest.approx(cw.mean_reproj_error, rel=1e-6)
    np.testing.assert_array_equal(dg["picked_views"], dw["picked_views"])
    np.testing.assert_array_equal(dg["active"], dw["active"])
    assert _rel(dg["t_cw"], dw["t_cw"]) < 1e-6
    assert _rel(dg["per_view_rmse"], dw["per_view_rmse"]) < 1e-6


def test_batch_matches_jax(jobs, port_batch):
    want = j_cc.calibrate_camera_batch([(n, j_types.CornerDataset(**d)) for n, d in jobs],
                                       j_cc.CameraCalibratorOptions(**OPTS))
    assert len(port_batch) == len(want) == len(jobs)
    for got, w in zip(port_batch, want):
        _same(got, w)
        assert got[1]["init_focal"] == pytest.approx(w[1]["init_focal"], rel=1e-9)


@pytest.mark.parametrize("job", range(len(TRUE_PARAMS)))
def test_batch_matches_per_job_calibration(jobs, port_batch, job):
    name, d = jobs[job]
    single = t_cc.calibrate_camera(t_types.CornerDataset(**d), name,
                                   t_cc.CameraCalibratorOptions(**OPTS), device="cpu")
    _same(port_batch[job], single)


def test_lanes_loop_matches_the_loop_per_lane():
    """lm_optimize_lanes on three independent curve fits (one converges
    fast, one needs damping retries, one hits the iteration cap) equals
    lm_optimize run on each alone."""
    rng = np.random.default_rng(0)
    x = torch.linspace(0.0, 3.0, 40, dtype=torch.float64)
    truth = torch.tensor([[1.0, -0.5, 0.3], [2.0, 1.5, -1.0], [0.5, 3.0, 0.8]],
                         dtype=torch.float64)
    y = truth[:, :1] * torch.exp(-truth[:, 1:2] * x) + truth[:, 2:]
    y = y + torch.as_tensor(1e-3 * rng.normal(size=y.shape))
    starts = torch.tensor([[0.9, -0.4, 0.2], [8.0, -2.0, 5.0], [0.1, 0.1, 0.1]],
                          dtype=torch.float64)
    layout = blocks.BlockLayout([blocks.BlockSpec("p", (3,))])
    mask = layout.free_mask()
    cfg = lm.LMConfig(max_iters=12, ftol=1e-6)

    def fns(yi):
        return lm.make_dense_linearizer(
            lambda prm: prm["p"][0] * torch.exp(-prm["p"][1] * x) + prm["p"][2] - yi, layout)

    singles = []
    for i in range(3):
        lin, cost, retract = fns(y[i])
        singles.append(lm.lm_optimize(lin, cost, retract, {"p": starts[i]}, mask, cfg))
    from torch.func import vmap
    res = lm.lm_optimize_lanes(
        lambda prm: vmap(lambda p, yi: fns(yi)[0](p))(prm, y),
        lambda prm: vmap(lambda p, yi: fns(yi)[1](p))(prm, y),
        vmap(layout.retract), {"p": starts}, mask.expand(3, -1), cfg)
    assert len({s.iterations for s in singles}) > 1, [s.iterations for s in singles]
    for i, s in enumerate(singles):
        assert int(res.iterations[i]) == s.iterations
        assert int(res.status[i]) == s.status
        torch.testing.assert_close(res.cost[i], s.cost, rtol=1e-9, atol=0)
        torch.testing.assert_close(res.params["p"][i], s.params["p"], rtol=1e-9, atol=0)
        torch.testing.assert_close(res.cost_history[i], s.cost_history, rtol=1e-9, atol=0,
                                   equal_nan=True)
