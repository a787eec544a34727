"""Port parity: core/spline_estimator.py.

On ``__graft_entry__._tiny_problem()`` in float64, the port's scatter and
fast (chunk-local, fused Gram) linearizers give the (H, g, cost) of the
JAX package's fast linearizer; problem construction, initialization,
board points and the IMU evaluation helpers match on the same numpy
inputs; ``optimize_stages`` runs a short checkpointed schedule.
Tolerance: 1e-9 of the largest entry for H and g (sums of ~1e3 float64
products taken in a different order), 1e-12 relative for the cost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from openimucameracalibrator_torch.core import spline_estimator as tse
from openimucameracalibrator_torch.models import cameras as t_cam
from openimucameracalibrator_torch.solver import lm as t_lm
from openimucameracalibrator_torch.utils import convert, synthetic
from openimucameracalibrator_torch.utils import types as t_types
from openimucameracalibrator_tpu.core import spline_estimator as jse
from openimucameracalibrator_tpu.utils import types as j_types


def _fields(p):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in p._asdict().items()}


@pytest.fixture(scope="module")
def tiny():
    p, params = ge._tiny_problem(jnp.float64)
    tp = convert.problem_from_numpy(_fields(p), device="cpu")
    tparams = convert.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                        device="cpu")
    back = convert.params_to_numpy(tparams)
    assert all(np.array_equal(back[k], np.asarray(v)) for k, v in params.items())
    return p, params, tp, tparams


@pytest.fixture(scope="module")
def jax_fast_linearize(tiny):
    p, params, _, _ = tiny
    layout = jse.build_layout(p)
    plans, arrs = jse.plan_fast_assembly(p, obs_chunk=64, imu_chunk=32)
    lin = jse.make_fast_linearizer(p, layout, plans)
    bases = jse.plan_bases(plans)
    return [np.asarray(a) for a in jax.jit(lambda q: lin(q, arrs, bases))(params)]


def _close(got, want):
    H, g, c = (a.numpy() if isinstance(a, torch.Tensor) else a for a in got)
    Hj, gj, cj = want
    np.testing.assert_allclose(H, Hj, rtol=0, atol=1e-9 * np.abs(Hj).max())
    np.testing.assert_allclose(g, gj, rtol=0, atol=1e-9 * np.abs(gj).max())
    np.testing.assert_allclose(float(c), float(cj), rtol=1e-12)


@pytest.mark.parametrize("method", ["scatter", "scatter_chunked", "fast"])
def test_linearize_matches_jax(method, tiny, jax_fast_linearize):
    _, _, tp, tparams = tiny
    layout = tse.build_layout(tp)
    if method == "fast":
        plans, arrs = tse.plan_fast_assembly(tp, obs_chunk=64, imu_chunk=32)
        got = tse.make_fast_linearizer(tp, layout, plans)(tparams, arrs)
    else:
        chunk = 100 if method == "scatter_chunked" else None
        got = tse.make_solver_functions(tp, layout, reproj_chunk=chunk)[0](tparams)
    _close(got, jax_fast_linearize)
    # The cost functions agree with the linearizers' cost.
    lin, cost = tse.make_solver_functions_fast(tp, layout, obs_chunk=64, imu_chunk=32)
    np.testing.assert_allclose(float(cost(tparams)), float(jax_fast_linearize[2]), rtol=1e-12)


def test_chunk_plan_matches_jax(tiny):
    p, _, tp, _ = tiny
    jplans, _ = jse.plan_fast_assembly(p, obs_chunk=64, imu_chunk=32)
    tplans, tarrs = tse.plan_fast_assembly(tp, obs_chunk=64, imu_chunk=32)
    for a, b in zip(jplans, tplans):
        assert (a.n_chunks, a.chunk, a.w_s, a.w_r) == (b.n_chunks, b.chunk, b.w_s, b.w_r)
        np.testing.assert_array_equal(np.asarray(a.s_base), b.s_base)
        np.testing.assert_array_equal(np.asarray(a.r_base), b.r_base)
    assert tarrs["obs_t"].shape == (jplans[0].n_chunks, 64)
    assert not tarrs["obs_valid"].reshape(-1)[tp.obs_t.shape[0]:].any()


def test_board_points_scatter_equals_fast(tiny):
    """With the POINTS block on, both port linearizers agree (the fast one
    through the board-point run segment of the fused Gram), and the
    problem fields match the JAX package's enable_board_points."""
    p, params, tp, tparams = tiny
    rng = np.random.default_rng(3)
    cov = np.stack([np.diag(rng.uniform(1e-6, 4e-6, 3))] * 12)
    rcov = np.stack([np.diag(rng.uniform(0.5, 2.0, 2))] * 12)
    board = np.c_[rng.uniform(0.0, 0.3, (12, 2)), np.zeros(12)]
    ids = np.arange(p.obs_t.shape[0]) % 12
    kw = dict(point_cov=cov, reproj_cov=rcov, board_points=board, obs_pt_id=ids)
    jp = jse.enable_board_points(p, **kw)
    tpp = tse.enable_board_points(tp, **kw)
    assert tpp.n_points == jp.n_points == 12
    for k in ("obs_pt_id", "obs_sqrt_info", "pt_prior_mean", "pt_prior_sqrt_info"):
        np.testing.assert_allclose(getattr(tpp, k).numpy(), np.asarray(getattr(jp, k)),
                                   rtol=1e-12)
    prm = dict(tparams, points=tpp.pt_prior_mean + 1e-3)
    layout = tse.build_layout(tpp)
    plans, arrs = tse.plan_fast_assembly(tpp, obs_chunk=64, imu_chunk=32)
    H1, g1, c1 = tse.make_solver_functions(tpp, layout)[0](prm)
    H2, g2, c2 = tse.make_fast_linearizer(tpp, layout, plans)(prm, arrs)
    np.testing.assert_allclose(H2.numpy(), H1.numpy(), rtol=0, atol=1e-9 * H1.abs().max().item())
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=0, atol=1e-9 * g1.abs().max().item())
    np.testing.assert_allclose(float(c2), float(c1), rtol=1e-12)


def test_build_problem_init_and_evaluation_match_jax():
    """build_problem, init_spline_params and evaluate_imu_components on a
    small rendered scene (numpy inputs shared by both packages)."""
    sc = synthetic.make_imu_camera_scene(
        t_cam.get_model("pinhole"), [437.0, 437.5, 481.0, 271.5], duration=3.0, cam_fps=8.0,
        imu_rate=50.0, time_offset=-0.05, seed=2, device="cpu")
    corners = dict(times=sc.frame_times, points2d=sc.observations, valid=sc.obs_valid,
                   board_points=np.asarray(sc.board.points), image_size=sc.image_size, fps=8.0)
    calib = dict(model_name="pinhole", params=sc.cam_params, image_size=sc.image_size,
                 mean_reproj_error=0.0, fps=8.0)
    imu = dict(times=sc.imu_times, accel=sc.accel, gyro=sc.gyro)
    sew = dict(dt_so3=0.1, dt_r3=0.1, std_so3=0.002, std_r3=0.02, cam_fps=8.0)
    poses = dict(times=sc.frame_times, q_w_c=sc.q_w_c, t_w_c=sc.t_w_c,
                 valid=np.ones(len(sc.frame_times), bool), board_points=np.asarray(sc.board.points))
    out = {}
    for name, mod, types in (("jax", jse, j_types), ("torch", tse, t_types)):
        kw = {} if name == "jax" else dict(device="cpu")
        prob = mod.build_problem(types.CornerDataset(**corners), types.CameraCalibration(**calib),
                                 types.ImuData(**imu), types.SplineWeightingData(**sew),
                                 -0.05, True, **kw)
        prm = mod.init_spline_params(types.PoseDataset(**poses), sc.q_i_c, sc.t_i_c, prob,
                                     types.ImuData(**imu), pose_time_offset=-0.05, **kw)
        out[name] = (prob, prm)
    (jp, jprm), (tp, tprm) = out["jax"], out["torch"]
    for k, v in _fields(jp).items():
        w = getattr(tp, k)
        if isinstance(w, torch.Tensor):
            np.testing.assert_allclose(w.numpy(), v, rtol=1e-15)
        else:
            assert w == v, k
    for k in jprm:
        np.testing.assert_allclose(tprm[k].numpy(), np.asarray(jprm[k]), rtol=0, atol=1e-12)
    t = np.linspace(0.2, 2.5, 23)
    want = jax.jit(lambda prm, tt: jse.evaluate_imu_components(jp, prm, tt))(jprm, jnp.asarray(t))
    got = tse.evaluate_imu_components(tp, tprm, torch.as_tensor(t))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-10)


def test_optimize_stages_checkpoint_resume(tiny, tmp_path):
    """A two-stage schedule lowers the cost, snapshots each stage, and a
    rerun restores both stages with their solver state."""
    _, _, tp, tparams = tiny
    schedule = [(frozenset(tse.DEFAULT_FLAGS), 3),
                (frozenset(tse.DEFAULT_FLAGS | {tse.CAM_LINE_DELAY}), 2)]
    cfg = t_lm.LMConfig(max_iters=5, ftol=0.0)
    ck = str(tmp_path / "ckpt")
    kw = dict(config=cfg, checkpoint_dir=ck, strategy="fused", obs_chunk=64, imu_chunk=32)
    r1 = tse.optimize_stages(tp, tparams, schedule, **kw)
    assert [r.iterations for r in r1] == [3, 2]
    cost0 = float(tse.make_solver_functions_fast(tp, tse.build_layout(tp), 64, 32)[1](tparams))
    hist = r1[0].cost_history.numpy()[:3]
    assert np.all(np.isfinite(hist)) and hist[-1] < cost0
    r2 = tse.optimize_stages(tp, tparams, schedule, **kw)
    for a, b in zip(r1, r2):
        assert (b.iterations, b.status, b.converged) == (a.iterations, a.status, a.converged)
    np.testing.assert_allclose(r2[-1].params["t_r3"].numpy(), r1[-1].params["t_r3"].numpy(),
                               rtol=1e-12)
    changed = tp._replace(gyro_meas=tp.gyro_meas + 1e-3)
    assert tse.optimize_stages(changed, tparams, schedule, **kw)[0].iterations == 3


def test_solve_fn_is_dense_only(tiny):
    """Below BANDED_MIN_DIM "auto" is the dense solve; "banded", or "auto"
    from ``banded_min_dim``, looks for a slab decomposition; the tiny
    problem (2 s) has none, so "auto" falls back to the dense solve and
    "banded" raises, as in the JAX package (tests/test_torch_banded.py
    holds the banded solve itself)."""
    from openimucameracalibrator_torch.solver import banded as t_banded

    _, _, tp, _ = tiny
    layout = tse.build_layout(tp)
    assert tse.make_solve_fn(tp, layout, "auto") is None
    assert tse.make_solve_fn(tp, layout, "dense") is None
    assert t_banded.from_problem(layout, tp, tse.ORDER) is None
    with pytest.raises(ValueError, match="slab decomposition"):
        tse.make_solve_fn(tp, layout, "banded")
    assert tse.make_solve_fn(tp, layout, "auto", banded_min_dim=10) is None
