"""Port parity: calibrated PnP, RANSAC and pose estimation (ops/pnp.py,
core/pose_estimator.py, apps/estimate_poses.py) against the JAX package.

Inputs are numpy from a seed, handed to both packages; everything runs
on the CPU in float64 (the JAX side jitted, x64 on).

* ``pnp_dlt`` and ``reprojection_errors_normalized``: 1e-9 relative.
* ``ransac_pnp_planar`` / ``ransac_pnp`` fed JAX's own uniforms (the
  port's private ``_ransac_pnp*`` take them): the same best hypothesis,
  q/t within 1e-9, the same inlier mask and count.
* ``estimate_poses``, each side with its own random stream: the same
  ``valid`` flags, q/t within 1e-6 where valid (both refine to the same
  minimum), a corrupted view flagged on both sides.
* ``optimize_board_points``: points and covariances within 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.apps import estimate_poses as t_cli
from openimucameracalibrator_torch.core import pose_estimator as t_pe
from openimucameracalibrator_torch.models import cameras as t_cameras
from openimucameracalibrator_torch.ops import lie as t_lie
from openimucameracalibrator_torch.ops import pnp as t_pnp
from openimucameracalibrator_torch.utils import io as t_io
from openimucameracalibrator_torch.utils import synthetic as t_synthetic
from openimucameracalibrator_torch.utils import types as t_types
from openimucameracalibrator_tpu.core import pose_estimator as j_pe
from openimucameracalibrator_tpu.ops import pnp as j_pnp
from openimucameracalibrator_tpu.utils import types as j_types

CAM = [437.0, 437.5, 481.0, 271.5]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _T(x):
    return torch.as_tensor(np.array(x))


def _q_close(qa, qb, tol):
    """Quaternions equal up to sign, within tol."""
    qa, qb = np.asarray(qa), np.asarray(qb)
    s = np.sign(np.sum(qa * qb, -1, keepdims=True))
    np.testing.assert_allclose(qa * s, qb, rtol=0, atol=tol)


def _pnp_problem(rng, B=5, P=12, planar=False):
    """B views of P board points (z = 0 when planar), normalized bearings
    with 1e-3 noise, one masked point per view."""
    pts = np.c_[rng.uniform(-0.3, 0.3, (P, 2)),
                np.zeros(P) if planar else rng.uniform(-0.1, 0.1, P)]
    rv = rng.normal(size=(B, 3)) * 0.3
    q = t_lie.so3_exp(_T(rv)).numpy()
    t = np.c_[rng.uniform(-0.1, 0.1, (B, 2)), rng.uniform(0.8, 1.2, B)]
    pc = t_lie.quat_rotate(_T(q)[:, None], _T(pts)[None]).numpy() + t[:, None]
    brg = pc[..., :2] / pc[..., 2:] + 1e-3 * rng.normal(size=(B, P, 2))
    mask = np.ones((B, P), bool)
    mask[np.arange(B), rng.integers(0, P, B)] = False
    return pts, brg, mask, q, t


def test_pnp_dlt_and_reprojection_match_jax(rng):
    pts, brg, mask, q, t = _pnp_problem(rng)
    P = pts.shape[0]
    pts_b = np.broadcast_to(pts, (len(q), P, 3))
    qj, tj = j_pnp.pnp_dlt(jnp.asarray(pts_b), jnp.asarray(brg), jnp.asarray(mask))
    qt, tt = t_pnp.pnp_dlt(_T(pts_b), _T(brg), _T(mask))
    assert _rel(qt.numpy(), np.asarray(qj)) < 1e-9
    assert _rel(tt.numpy(), np.asarray(tj)) < 1e-9
    _q_close(qt.numpy(), q, 0.05)  # and near the truth
    ej = j_pnp.reprojection_errors_normalized(qj, tj, jnp.asarray(pts_b), jnp.asarray(brg),
                                              jnp.asarray(mask))
    et = t_pnp.reprojection_errors_normalized(qt, tt, _T(pts_b), _T(brg), _T(mask))
    np.testing.assert_array_equal(np.isinf(et.numpy()), ~mask)
    assert _rel(et.numpy()[mask], np.asarray(ej)[mask]) < 1e-9


@pytest.mark.parametrize("planar", [True, False], ids=["planar", "3d"])
def test_ransac_matches_jax_on_the_same_uniforms(rng, planar):
    """Fed JAX's uniforms, the port picks the same subsets, hence the same
    best hypothesis, inliers and count; two gross outliers stay out."""
    pts, brg, mask, _, _ = _pnp_problem(rng, B=1, P=20, planar=planar)
    brg, mask = brg[0], mask[0]
    brg[3] += 0.2
    brg[7] -= 0.3
    key = jax.random.PRNGKey(5)
    K = 64
    u = np.asarray(jax.random.uniform(key, (K, len(mask))))
    j_fn, t_fn = ((j_pnp.ransac_pnp_planar, t_pnp._ransac_pnp_planar) if planar
                  else (j_pnp.ransac_pnp, t_pnp._ransac_pnp))
    qj, tj, inl_j, cnt_j = j_fn(jnp.asarray(pts), jnp.asarray(brg), jnp.asarray(mask), key,
                                num_hypotheses=K, inlier_thresh=0.01)
    qt, tt, inl_t, cnt_t = t_fn(_T(pts), _T(brg), _T(mask), _T(u), inlier_thresh=0.01)
    assert int(cnt_t) == int(cnt_j)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert _rel(qt.numpy(), np.asarray(qj)) < 1e-9
    assert _rel(tt.numpy(), np.asarray(tj)) < 1e-9
    assert not inl_t[3] and not inl_t[7] and int(cnt_t) >= 15


def test_ransac_public_functions_draw_from_the_generator(rng):
    """The public RANSACs draw (K, P) uniforms from the generator: the
    same seed gives the same answer as the private function on those
    uniforms."""
    pts, brg, mask, _, _ = _pnp_problem(rng, B=1, P=16, planar=True)
    args = (_T(pts), _T(brg[0]), _T(mask[0]))
    for public, private in ((t_pnp.ransac_pnp_planar, t_pnp._ransac_pnp_planar),
                            (t_pnp.ransac_pnp, t_pnp._ransac_pnp)):
        out = public(*args, torch.Generator().manual_seed(3), num_hypotheses=32)
        u = torch.rand((32, 16), generator=torch.Generator().manual_seed(3),
                       dtype=torch.float64)
        ref = private(*args, u)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def _corner_data(scene, corrupt_view=None):
    pts = np.array(scene.observations)
    if corrupt_view is not None:
        pts[corrupt_view] += np.random.default_rng(0).normal(size=pts[corrupt_view].shape) * 80.0
    return dict(times=scene.frame_times, points2d=pts, valid=scene.obs_valid,
                board_points=np.asarray(scene.board.points), image_size=scene.image_size,
                fps=30.0)


def _calib_data():
    return dict(model_name="pinhole", params=np.asarray(CAM), image_size=(960, 540),
                mean_reproj_error=0.0)


@pytest.fixture(scope="module")
def scenes():
    """The JAX tests' two pose scenes (40 views, seed 7; 30 views, seed 9,
    view 5 corrupted), made by the port from numpy seeds."""
    model = t_cameras.get_model("pinhole")
    clean = t_synthetic.make_intrinsics_scene(model, CAM, num_views=40, noise_px=0.2, seed=7,
                                              device="cpu")
    corrupt = t_synthetic.make_intrinsics_scene(model, CAM, num_views=30, noise_px=0.1, seed=9,
                                                device="cpu")
    return {"clean": (clean, _corner_data(clean)), "corrupt": (corrupt, _corner_data(corrupt, 5))}


@pytest.fixture(scope="module")
def pose_pairs(scenes):
    """{name: (scene, corners, JAX poses, port poses)}."""
    out = {}
    for name, (scene, data) in scenes.items():
        pj = j_pe.estimate_poses(j_types.CornerDataset(**data),
                                 j_types.CameraCalibration(**_calib_data()))
        pt = t_pe.estimate_poses(t_types.CornerDataset(**data),
                                 t_types.CameraCalibration(**_calib_data()), device="cpu")
        out[name] = (scene, data, pj, pt)
    return out


@pytest.mark.parametrize("name", ["clean", "corrupt"])
def test_estimate_poses_matches_jax(pose_pairs, name):
    _, _, pj, pt = pose_pairs[name]
    np.testing.assert_array_equal(pt.valid, pj.valid)
    v = pt.valid
    _q_close(pt.q_w_c[v], pj.q_w_c[v], 1e-6)
    np.testing.assert_allclose(pt.t_w_c[v], pj.t_w_c[v], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pt.times, pj.times)
    if name == "corrupt":
        assert not pt.valid[5] and pt.valid.sum() >= 25


def test_estimate_poses_recovers_the_truth(pose_pairs):
    """The JAX test's bars (test_pose_and_rotation.py), on the port alone."""
    scene, _, _, poses = pose_pairs["clean"]
    v = poses.valid
    assert v.sum() >= 35
    terr = np.linalg.norm(poses.t_w_c[v] - scene.t_w_c[v], axis=-1)
    rerr = torch.linalg.vector_norm(t_lie.quat_boxminus(
        _T(poses.q_w_c[v]), _T(scene.q_w_c[v])), dim=-1).numpy()
    assert np.percentile(terr, 90) < 0.008
    assert np.percentile(rerr, 90) < 0.008


def test_optimize_board_points_matches_jax(pose_pairs):
    _, data, _, pt = pose_pairs["clean"]
    poses = dict(times=pt.times, q_w_c=pt.q_w_c, t_w_c=pt.t_w_c, valid=pt.valid,
                 board_points=pt.board_points)
    pj, info_j = j_pe.optimize_board_points(j_types.CornerDataset(**data),
                                            j_types.CameraCalibration(**_calib_data()),
                                            j_types.PoseDataset(**poses), min_obs=20)
    ptt, info_t = t_pe.optimize_board_points(t_types.CornerDataset(**data),
                                             t_types.CameraCalibration(**_calib_data()),
                                             t_types.PoseDataset(**poses), min_obs=20,
                                             device="cpu")
    assert info_t["refined"].any()
    np.testing.assert_array_equal(info_t["refined"], info_j["refined"])
    assert _rel(ptt.board_points, pj.board_points) < 1e-8
    for k in ("point_cov", "reproj_cov", "std_mm"):
        assert _rel(info_t[k], info_j[k]) < 1e-8, k


@pytest.mark.parametrize("ext", [".npz", ".calibdata"])
def test_estimate_poses_cli(scenes, tmp_path, capsys, ext):
    """The port's CLI on the CPU writes the poses estimate_poses gives,
    in either artifact, readable by load_pose_dataset. Like the JAX CLI it
    does not refine the board points, and says so when asked to."""
    _, data = scenes["corrupt"]
    corners, calib = str(tmp_path / "c.uson"), str(tmp_path / "calib.json")
    t_io.save_corners(t_types.CornerDataset(**data), corners)
    t_io.save_camera_calibration(t_types.CameraCalibration(**_calib_data()), calib)
    out = str(tmp_path / f"poses{ext}")
    t_cli.main(["--input_corners", corners, "--camera_calibration_json", calib,
                "--output_pose_dataset", out, "--device", "cpu"])
    back = t_cli.load_pose_dataset(out)
    ref = t_pe.estimate_poses(t_io.load_corners(corners), t_io.load_camera_calibration(calib),
                              device="cpu")
    np.testing.assert_array_equal(back.valid, ref.valid)
    _q_close(back.q_w_c[ref.valid], ref.q_w_c[ref.valid], 1e-9)
    np.testing.assert_allclose(back.t_w_c[ref.valid], ref.t_w_c[ref.valid], atol=1e-9)
    if ext == ".npz":
        capsys.readouterr()
        out2 = str(tmp_path / "poses_flag.npz")
        t_cli.main(["--input_corners", corners, "--camera_calibration_json", calib,
                    "--output_pose_dataset", out2, "--device", "cpu", "--optimize_board_points"])
        assert "run_calibration --optimize_board_points" in capsys.readouterr().err
        flagged = t_cli.load_pose_dataset(out2)
        np.testing.assert_array_equal(flagged.board_points, back.board_points)
        np.testing.assert_array_equal(flagged.q_w_c, back.q_w_c)
