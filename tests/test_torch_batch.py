"""Port parity: core/batch_estimator.py and the fast linearizer's variants.

The two equality sequences of ``tests/test_batch_estimator.py`` (3.0 s and
4.5 s, seeds 3 and 4, pinhole, 20 fps, 100 Hz IMU, obs/imu chunks 512/128)
are made once with the port's scene generator in float64 and handed to
both packages as numpy (``utils/convert``):

* the stacked batch (arrays, shared chunk bases, per-sequence overrides,
  padding masks) equals the JAX package's;
* independent mode equals the JAX package's independent mode: the same
  iterations and statuses, costs within 1e-9 relative, parameters within
  1e-7;
* joint mode at N=1 equals the port's plain solve; the arrowhead solve
  equals a dense solve of the assembled joint system (1e-10 of the step);
* the batched linearizer equals the per-sequence one, in both chunk
  modes; the problem overrides through ``bases`` equal a rebuilt problem.

Marked slow: the 3-sequence joint recovery and the batch CLI against the
JAX CLI.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.core import batch_estimator as tbe
from openimucameracalibrator_torch.core import spline_estimator as tse
from openimucameracalibrator_torch.models import cameras as t_cam
from openimucameracalibrator_torch.ops import lie as t_lie
from openimucameracalibrator_torch.solver import lm as t_lm
from openimucameracalibrator_torch.utils import convert, synthetic
from openimucameracalibrator_torch.utils import types as t_types
from openimucameracalibrator_tpu.core import batch_estimator as jbe
from openimucameracalibrator_tpu.core import spline_estimator as jse
from openimucameracalibrator_tpu.solver import lm as j_lm

CAM = [437.0, 437.5, 481.0, 271.5]
CHUNKS = dict(obs_chunk=512, imu_chunk=128)


def _sequence(duration, seed, time_offset=-0.05):
    """One synthetic recording (the JAX test's settings) as the port's
    float64 CPU problem, its initial point and its scene."""
    scene = synthetic.make_imu_camera_scene(
        t_cam.get_model("pinhole"), CAM, duration=duration, cam_fps=20.0, imu_rate=100.0,
        time_offset=time_offset, noise_px=0.15, seed=seed, device="cpu")
    ds = t_types.CornerDataset(scene.frame_times, scene.observations, scene.obs_valid,
                               scene.board.points, scene.image_size, 20.0)
    calib = t_types.CameraCalibration("pinhole", np.asarray(CAM), scene.image_size, 0.0,
                                      fps=20.0)
    imu = t_types.ImuData(scene.imu_times, scene.accel, scene.gyro)
    sew = t_types.SplineWeightingData(dt_so3=0.1, dt_r3=0.1, std_so3=0.002, std_r3=0.02,
                                      cam_fps=20.0)
    p = tse.build_problem(ds, calib, imu, sew, time_offset, rolling_shutter=False,
                          device="cpu")
    poses = t_types.PoseDataset(scene.frame_times, scene.q_w_c, scene.t_w_c,
                                np.ones(len(scene.frame_times), bool), scene.board.points)
    params0 = tse.init_spline_params(poses, np.asarray(scene.q_i_c) + 0.005,
                                     np.asarray(scene.t_i_c) + 0.004, p, imu,
                                     pose_time_offset=time_offset, device="cpu")
    return p, params0, scene


def _fields(p):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in p._asdict().items()}


def _to_jax(p, params):
    jp = jse.SplineProblem(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                              for k, v in _fields(p).items()})
    return jp, {k: jnp.asarray(v) for k, v in convert.params_to_numpy(params).items()}


@pytest.fixture(scope="module")
def seqs():
    """The two equality sequences (different lengths: padding is exercised)."""
    return [_sequence(3.0, seed=3), _sequence(4.5, seed=4)]


def test_sequence_batch_matches_jax(seqs):
    """build_sequence_batch and stack_params give the JAX package's arrays,
    with the problems carried across as numpy."""
    jax_in = [_to_jax(p, prm) for p, prm, _ in seqs]
    jb = jbe.build_sequence_batch([p for p, _ in jax_in], **CHUNKS)
    fields = dict(p_ref={k: (np.asarray(v) if hasattr(v, "shape") else v)
                         for k, v in jb.p_ref._asdict().items()},
                  plans=[(pl.n_chunks, pl.chunk, pl.w_s, pl.w_r, pl.s_base, pl.r_base)
                         for pl in jb.plans],
                  arrs={k: np.asarray(v) for k, v in jb.arrs.items()},
                  bases={k: np.asarray(v) for k, v in jb.bases.items()},
                  pad_masks=jb.pad_masks, knot_counts=jb.knot_counts, n_seq=jb.n_seq)
    carried = convert.sequence_batch_from_numpy(fields, device="cpu")
    tb = tbe.build_sequence_batch(convert.problems_from_numpy(
        [_fields(p) for p, _, _ in seqs], device="cpu"), **CHUNKS)
    for got in (tb, carried):
        assert got.n_seq == 2 and got.knot_counts == jb.knot_counts
        np.testing.assert_array_equal(got.pad_masks, jb.pad_masks)
        for a, b in zip(got.plans, jb.plans):
            assert (a.n_chunks, a.chunk, a.w_s, a.w_r) == (b.n_chunks, b.chunk, b.w_s, b.w_r)
        assert set(got.arrs) == set(jb.arrs) and set(got.bases) == set(jb.bases)
        for k, v in jb.arrs.items():
            np.testing.assert_array_equal(got.arrs[k].numpy(), np.asarray(v), err_msg=k)
        for k, v in jb.bases.items():
            np.testing.assert_array_equal(np.asarray(got.bases[k]), np.asarray(v), err_msg=k)
    jstack = jbe.stack_params(jb, [prm for _, prm in jax_in])
    tstack = tbe.stack_params(tb, [prm for _, prm, _ in seqs])
    for k, v in jstack.items():
        np.testing.assert_array_equal(tstack[k].numpy(), np.asarray(v), err_msg=k)
    back = tbe.unstack_params(tb, tstack)
    for (_, prm, _), got in zip(seqs, back):
        assert all(torch.equal(got[k], prm[k]) for k in prm)


def test_independent_matches_jax(seqs):
    """Independent mode against the JAX package's independent mode
    (vmap(lm_optimize)) on the same numpy inputs, float64."""
    jax_in = [_to_jax(p, prm) for p, prm, _ in seqs]
    cfg = dict(max_iters=4, ftol=0.0)
    rj = jbe.optimize_batch([p for p, _ in jax_in], [prm for _, prm in jax_in],
                            config=j_lm.LMConfig(**cfg), **CHUNKS)
    rt = tbe.optimize_batch([p for p, _, _ in seqs], [prm for _, prm, _ in seqs],
                            config=t_lm.LMConfig(**cfg), **CHUNKS)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost), rtol=1e-9)
    for got, want in zip(rt.params, rj.params):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0, atol=1e-7,
                                       err_msg=k)


def test_joint_single_sequence_matches_plain(seqs):
    """N=1: the arrowhead Schur solve is the full damped solve."""
    p, prm0, _ = seqs[0]
    cfg = t_lm.LMConfig(max_iters=6, ftol=0.0)
    res_j = tbe.optimize_batch([p], [prm0], config=cfg, mode="joint", **CHUNKS)
    ref = tse.optimize(p, prm0, config=cfg)
    assert res_j.iterations == ref.iterations and res_j.status == ref.status
    np.testing.assert_allclose(float(res_j.cost), float(ref.cost), rtol=1e-9)
    for k, v in ref.params.items():
        np.testing.assert_allclose(res_j.params[0][k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("lam", [1e-4, 1e-1, 10.0])
def test_arrowhead_matches_dense_solve(seqs, lam):
    """The batched-Cholesky Schur solve equals the Jacobi-equilibrated
    damped solve of the assembled (N*Dx + S) joint system."""
    batch = tbe.build_sequence_batch([p for p, _, _ in seqs], **CHUNKS)
    layout = tse.build_layout(batch.p_ref)
    H_b, g_b, _ = tbe.make_batch_linearizer(batch, layout)(
        tbe.stack_params(batch, [prm for _, prm, _ in seqs]))
    flags = tse.DEFAULT_FLAGS | {tse.CAM_LINE_DELAY}
    m = tbe._batch_masks(batch, layout, flags)
    eye = torch.eye(layout.tangent_dim, dtype=torch.float64)
    H_b = H_b * m[:, :, None] * m[:, None, :] + eye * (1.0 - m)[:, None, :]
    g_b = g_b * m
    delta = tbe.make_arrowhead_solver(layout, tbe.DEFAULT_SHARED)(H_b, g_b, lam)

    shared = np.concatenate([np.arange(layout.slice_of(n).start, layout.slice_of(n).stop)
                             for n in tbe.DEFAULT_SHARED])
    own = np.setdiff1d(np.arange(layout.tangent_dim), shared)
    N, Dx, S = batch.n_seq, own.size, shared.size
    rows = [torch.as_tensor(i * Dx + np.arange(Dx)) for i in range(N)]
    sh = torch.as_tensor(N * Dx + np.arange(S))
    Hj = torch.zeros((N * Dx + S,) * 2, dtype=torch.float64)
    gj = torch.zeros(N * Dx + S, dtype=torch.float64)
    o, s_ = torch.as_tensor(own), torch.as_tensor(shared)
    for i in range(N):
        Hj[rows[i][:, None], rows[i][None, :]] = H_b[i][o[:, None], o[None, :]]
        Hj[rows[i][:, None], sh[None, :]] = H_b[i][o[:, None], s_[None, :]]
        Hj[sh[:, None], rows[i][None, :]] = H_b[i][s_[:, None], o[None, :]]
        Hj[sh[:, None], sh[None, :]] += H_b[i][s_[:, None], s_[None, :]]
        gj[rows[i]] = g_b[i][o]
        gj[sh] += g_b[i][s_]
    sc = torch.rsqrt(torch.clamp(torch.diagonal(Hj), min=1e-12))
    y = torch.linalg.solve(Hj * sc[:, None] * sc[None, :] + lam * torch.eye(Hj.shape[0],
                                                                            dtype=Hj.dtype),
                           -(sc * gj))
    want = sc * y
    scale = want.abs().max().item()
    for i in range(N):
        np.testing.assert_allclose(delta[i][o].numpy(), want[rows[i]].numpy(), rtol=0,
                                   atol=1e-10 * scale)
        np.testing.assert_allclose(delta[i][s_].numpy(), want[sh].numpy(), rtol=0,
                                   atol=1e-10 * scale)


@pytest.mark.parametrize("field", ["dt_so3", "dt_r3", "model_name", "rolling_shutter",
                                   "intrinsics", "POINTS"])
def test_batch_rejects_mismatched_statics(seqs, field):
    p = seqs[0][0]
    if field == "intrinsics":
        p2 = p._replace(cam_params=p.cam_params + 1.0)
    elif field == "POINTS":
        p2 = tse.enable_board_points(p)
    elif field == "model_name":
        p2 = p._replace(model_name="fisheye")
    elif field == "rolling_shutter":
        p2 = p._replace(rolling_shutter=True)
    else:
        p2 = p._replace(**{field: getattr(p, field) * 2})
    with pytest.raises(ValueError, match=field):
        tbe.build_sequence_batch([p, p2])


@pytest.mark.parametrize("sequential", [False, True], ids=["all-chunks", "sequential"])
def test_batched_linearizer_matches_per_sequence(seqs, sequential):
    """The N-sequence linearizer (one kernel launch per family for all N,
    or one per chunk in sequential mode) gives each sequence's own
    (H, g, cost), padding blocks zero; sequential equals the default mode."""
    batch = tbe.build_sequence_batch([p for p, _, _ in seqs], **CHUNKS)
    layout = tse.build_layout(batch.p_ref)
    params_b = tbe.stack_params(batch, [prm for _, prm, _ in seqs])
    H_b, g_b, c_b = tbe.make_batch_linearizer(batch, layout, sequential=sequential)(params_b)
    if sequential:
        H_d, g_d, c_d = tbe.make_batch_linearizer(batch, layout)(params_b)
        np.testing.assert_allclose(H_b.numpy(), H_d.numpy(), rtol=0,
                                   atol=1e-12 * H_d.abs().max().item())
        np.testing.assert_allclose(g_b.numpy(), g_d.numpy(), rtol=0,
                                   atol=1e-12 * g_d.abs().max().item())
        np.testing.assert_allclose(c_b.numpy(), c_d.numpy(), rtol=1e-12)
    for i, (p, prm, _) in enumerate(seqs):
        lay = tse.build_layout(p)
        H, g, c = tse.make_solver_functions_fast(p, lay, **CHUNKS)[0](prm)
        own = torch.as_tensor(batch.pad_masks[i] > 0)
        Hi, gi = H_b[i][own][:, own], g_b[i][own]
        np.testing.assert_allclose(Hi.numpy(), H.numpy(), rtol=0, atol=1e-9 * H.abs().max())
        np.testing.assert_allclose(gi.numpy(), g.numpy(), rtol=0, atol=1e-9 * g.abs().max())
        np.testing.assert_allclose(float(c_b[i]), float(c), rtol=1e-12)
        assert not H_b[i][~own].any() and not g_b[i][~own].any()


def test_problem_overrides_through_bases(seqs):
    """t0, w_accel, w_gyro, dt_bias and t_hi passed through ``bases`` give
    what a problem rebuilt with those values gives (one problem), in the
    linearizer and in the batch cost."""
    p, prm, _ = seqs[1]
    over = dict(t0=p.t0 - 0.013, w_accel=1.3 * p.w_accel, w_gyro=0.7 * p.w_gyro,
                dt_bias=1.1 * p.dt_bias, t_hi=p.t0 + 3.3)
    rebuilt = p._replace(**over)
    plans, arrs = tse.plan_fast_assembly(rebuilt, **CHUNKS)
    layout = tse.build_layout(p)
    want = tse.make_fast_linearizer(rebuilt, layout, plans)(prm, arrs)
    got = tse.make_fast_linearizer(p, layout, plans)(
        prm, arrs, {**tse.plan_bases(plans),
                    **{k: torch.tensor(v, dtype=torch.float64) for k, v in over.items()}})
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13,
                                   atol=1e-13 * b.abs().max().item())
    assert not np.allclose(want[0].numpy(), tse.make_fast_linearizer(p, layout, plans)(
        prm, arrs)[0].numpy())
    cost = tbe.make_batch_cost(p)(prm, arrs, over)
    np.testing.assert_allclose(float(cost), float(want[2]), rtol=1e-12)


def test_gram_dtype_casts_h_on_the_plain_path(seqs):
    """gram_dtype rounds H's operands (bfloat16 here) and leaves g and the
    cost in full precision."""
    p, prm, _ = seqs[0]
    plans, arrs = tse.plan_fast_assembly(p, **CHUNKS)
    layout = tse.build_layout(p)
    H, g, c = tse.make_fast_linearizer(p, layout, plans)(prm, arrs)
    Hb, gb, cb = tse.make_fast_linearizer(p, layout, plans, gram_dtype=torch.bfloat16)(
        prm, arrs)
    np.testing.assert_allclose(gb.numpy(), g.numpy(), rtol=0, atol=1e-12 * g.abs().max())
    assert float(cb) == float(c)
    err = ((Hb - H).abs().max() / H.abs().max()).item()
    assert 0 < err < 2 ** -7, err


@pytest.mark.slow
def test_joint_shares_rig_parameters():
    """The 3-sequence joint recovery of tests/test_batch_estimator.py."""
    seqs3 = [_sequence(4.0, seed=3), _sequence(5.5, seed=4), _sequence(4.5, seed=5)]
    res = tbe.optimize_batch([p for p, _, _ in seqs3], [prm for _, prm, _ in seqs3],
                             config=t_lm.LMConfig(max_iters=20, ftol=0.0), mode="joint",
                             **CHUNKS)
    for name in tbe.DEFAULT_SHARED:
        for i in range(1, 3):
            assert torch.equal(res.params[i][name], res.params[0][name])
    scene = seqs3[0][2]
    rot_err = torch.linalg.vector_norm(t_lie.quat_boxminus(
        res.params[0]["q_i_c"], torch.as_tensor(np.asarray(scene.q_i_c)))).item()
    assert rot_err < 0.02, rot_err
    np.testing.assert_allclose(res.params[0]["t_i_c"].numpy(), np.asarray(scene.t_i_c),
                               atol=0.04)


BATCH_CLI_KW = dict(duration=6.0, cam_fps=10.0, image_size=(640, 360), intrinsics_frames=25,
                    time_offset=-0.08, supersample=2, squares_x=8, squares_y=6,
                    square_length=0.06, marker_length=0.045)


@pytest.mark.slow
def test_batch_cli_matches_jax_cli(tmp_path):
    """The batch CLI on two make_recording pairs against the JAX CLI on the
    same MP4s and camera calibration (the JAX charuco stack loaded as
    tests/test_torch_charuco.py loads it), both in joint mode; both are
    held to tests/test_batch_cli.py's bars and to each other."""
    cv2 = pytest.importorskip("cv2")  # noqa: F841  (both CLIs decode the MP4s)
    import importlib
    import sys

    from test_torch_charuco import DEPENDENTS, QUADS, _reference_quads

    from openimucameracalibrator_torch.apps import batch_calibration as t_cli
    from openimucameracalibrator_torch.core import board_extractor, camera_calibrator
    from openimucameracalibrator_torch.utils import io, recorded

    recs = [recorded.make_recording(str(tmp_path / f"r{i}"), seed=s, device="cpu",
                                    **BATCH_CLI_KW) for i, s in enumerate((3, 11))]
    opts = board_extractor.BoardExtractorOptions(squares_x=8, squares_y=6,
                                                 square_length=0.06, marker_length=0.045)
    ds = board_extractor.extract_board_from_video(recs[0].cam_video, opts, device="cpu")
    calib, _ = camera_calibrator.calibrate_camera(ds, "division_undistortion", device="cpu")
    calib_path = str(tmp_path / "cam_calib.json")
    io.save_camera_calibration(calib, calib_path)
    argv = sum([["--recording", r.imu_cam_video] for r in recs], []) + [
        "--camera_calibration_json", calib_path, "--telemetry_format", "gopro",
        "--num_squares_x", "8", "--num_squares_y", "6", "--checker_size_m", "0.06",
        "--marker_size_m", "0.045", "--global_shutter", "--max_iters", "25"]
    out_t = t_cli.run(t_cli.build_parser().parse_args(
        argv + ["--output_json", str(tmp_path / "t.json"), "--device", "cpu"]))
    # The JAX CLI with the repaired quads module, taken out of sys.modules
    # again afterwards (as test_torch_charuco.py's fixture does).
    names = (QUADS,) + DEPENDENTS + ("openimucameracalibrator_tpu.apps.batch_calibration",)
    saved = {n: sys.modules.get(n) for n in names}
    try:
        _reference_quads()
        j_cli = importlib.import_module(names[-1])
        out_j = j_cli.run(j_cli.build_parser().parse_args(
            argv + ["--output_json", str(tmp_path / "j.json")]))
    finally:
        for n in names:
            if saved[n] is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = saved[n]
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == out_t
    for out in (out_t, out_j):
        assert out["n_sequences"] == 2 and out["mode"] == "joint"
        q = np.asarray(out["q_i_c"])
        ang = 2 * np.arccos(min(1.0, abs(float(np.dot(q, np.asarray(recs[0].q_i_c))))))
        assert ang < np.deg2rad(1.0), np.rad2deg(ang)
        np.testing.assert_allclose(out["t_i_c"], recs[0].t_i_c, atol=0.02)
        for seq in out["sequences"]:
            assert seq["mean_reproj_error_px"] < 2.0, seq
            assert abs(seq["time_offset_s"] - recs[0].time_offset) < 5e-3
    assert out_t["dt_so3"] == pytest.approx(out_j["dt_so3"])
    np.testing.assert_allclose(out_t["q_i_c"], out_j["q_i_c"], atol=2e-3)
    np.testing.assert_allclose(out_t["t_i_c"], out_j["t_i_c"], atol=5e-3)
    assert os.path.exists(tmp_path / "j.json")
