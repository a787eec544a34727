"""The port's pipeline slice as a whole: stages 4 to 7 and the
``run_calibration`` CLI, on the CPU in float64.

* The JAX ``run_calibration`` cannot be imported (its board extractor
  imports the unparseable ``detect/quads.py``), so the JAX chain of stages
  4 -> 5 -> 6 -> 7 is called function by function against the port's chain
  on the same corners, calibration and telemetry: the same biases and SEW
  (1e-12), the same valid views, poses within 1e-6, the time offset within
  the search tolerance 1e-4 s, rotation and gyro bias within 1e-6; with a
  global shutter, and with the DS3 rolling-shutter readout, which neither
  chain models (there both miss the truth by the same amount).
* The port's ``run_calibration.main(..., "--device", "cpu")`` on a tiny
  workspace seeded with corner files (no video decoding): its init and SEW
  equal the library chain's on the CLI's own calibration, its summary
  meets recovery bars (those of the JAX pipeline test,
  tests/test_recorded_e2e.py, and of the stage-8 tests), and it writes
  every artifact.
* What is not ported fails loudly, naming its ROADMAP.md item.
"""

import json
import os
import shutil
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.apps import run_calibration as t_run
from openimucameracalibrator_torch.core import imu_cam_rotation as t_rot
from openimucameracalibrator_torch.core import imu_camera_calibrator as t_icc
from openimucameracalibrator_torch.core import pose_estimator as t_pe
from openimucameracalibrator_torch.core import telemetry as t_tel
from openimucameracalibrator_torch.models import cameras as t_cameras
from openimucameracalibrator_torch.ops import sew as t_sew
from openimucameracalibrator_torch.utils import io as t_io
from openimucameracalibrator_torch.utils import synthetic as t_synthetic
from openimucameracalibrator_torch.utils import types as t_types
from openimucameracalibrator_tpu.core import imu_cam_rotation as j_rot
from openimucameracalibrator_tpu.core import pose_estimator as j_pe
from openimucameracalibrator_tpu.ops import sew as j_sew
from openimucameracalibrator_tpu.utils import types as j_types

CAM = [437.13, 489.07, 270.87, -1.4386e-06]
FPS = 10.0
TIME_OFFSET = -0.0813
LINE_DELAY = 30.895e-6  # s per row: the DS3 recording's, 16.7 ms over 540 rows


def _seed_workspace(ws, line_delay=0.0):
    """A 9 s imu-cam scene at 10 fps with a 100 Hz IMU and a 16-view
    intrinsics scene (division-undistortion camera): the two corner files
    run_calibration resumes from, and the generic telemetry json."""
    model = t_cameras.get_model("division_undistortion")
    sc = t_synthetic.make_imu_camera_scene(model, CAM, duration=9.0, cam_fps=FPS, imu_rate=100.0,
                                           time_offset=TIME_OFFSET, line_delay=line_delay,
                                           seed=3, device="cpu")
    isc = t_synthetic.make_intrinsics_scene(model, CAM, num_views=16, seed=3, device="cpu")
    t_io.save_corners(t_types.CornerDataset(isc.frame_times, isc.observations, isc.obs_valid,
                                            np.asarray(isc.board.points), isc.image_size, 30.0),
                      os.path.join(ws, "cam_corners.uson"))
    t_io.save_corners(t_types.CornerDataset(sc.frame_times, sc.observations, sc.obs_valid,
                                            np.asarray(sc.board.points), sc.image_size, FPS),
                      os.path.join(ws, "imu_cam_corners.uson"))
    tel = os.path.join(ws, "telemetry.json")
    t_tel.write_generic_json(t_types.CameraTelemetry(
        imu=t_types.ImuData(sc.imu_times, sc.accel, sc.gyro)), tel, cam_fps=FPS)
    return sc, ws, tel


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return _seed_workspace(str(tmp_path_factory.mktemp("ws")))


def _argv(ws, tel, *extra):
    return ["--path_calib_dataset", ws, "--telemetry_json", tel, "--board_type", "radon",
            "--global_shutter", "--workspace", ws, *extra]


def _port_chain(corners, calib, imu):
    """Stages 4 -> 5 -> 6 -> 7 of the port, as run_calibration calls them."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        biases = t_sew.estimate_static_biases(imu)
    poses = t_pe.estimate_poses(corners, calib, device="cpu")
    sew = t_sew.compute_sew(imu, corners.fps or 30.0)
    init = t_rot.estimate_imu_to_camera_rotation(poses, imu, device="cpu")
    return biases, poses, sew, init


def _jax_ransac_uniforms(n_views, n_points, seed=0):
    """The (views, hypotheses, points) uniforms the JAX ``estimate_poses``
    draws for ``n_views`` <= 512 (one chunk: one key, split per view)."""
    key = jax.random.split(jax.random.PRNGKey(seed), 1)[0]
    K = t_pe.PoseEstimatorOptions().num_hypotheses
    u = jax.vmap(lambda k: jax.random.uniform(k, (K, n_points)))(
        jax.random.split(key, n_views))
    return torch.as_tensor(np.array(u, np.float64))


@pytest.mark.parametrize("line_delay", [0.0, LINE_DELAY], ids=["global", "rolling"])
def test_stages_4_to_7_match_the_jax_chain(workspace, tmp_path, monkeypatch, line_delay):
    """Both chains on the same inputs.

    ``global``: each side draws its RANSAC hypotheses from its own
    generator; on global-shutter corners every good hypothesis finds the
    same inliers, so both refine to the same minimum.
    ``rolling`` (the DS3 recording's 16.7 ms readout): neither chain models
    the readout, so both are off the truth, and some corners sit near the
    inlier threshold, where the inlier set (hence the refined pose) depends
    on the hypothesis. The port is therefore handed JAX's own uniforms
    (same hypotheses); the chains must then agree as tightly as in
    ``global``, and their errors to the truth are the same.
    """
    sc, ws, tel_path = workspace if line_delay == 0.0 else _seed_workspace(str(tmp_path),
                                                                           line_delay)
    corners = t_io.load_corners(os.path.join(ws, "imu_cam_corners.uson"))
    tel = t_tel.read_generic_json(tel_path)
    calib = dict(model_name="division_undistortion", params=np.asarray(CAM),
                 image_size=corners.image_size, mean_reproj_error=0.0)
    if line_delay:
        real = t_pe._estimate_all_poses
        u = _jax_ransac_uniforms(*corners.valid.shape)
        monkeypatch.setattr(t_pe, "_estimate_all_poses",
                            lambda cam, obs, valid, pts, _, *a: real(cam, obs, valid, pts, u, *a))
    (ba_t, bg_t, src_t), pt, st, it = _port_chain(corners, t_types.CameraCalibration(**calib),
                                                   tel.imu)

    c = corners
    j_corners = j_types.CornerDataset(c.times, c.points2d, c.valid, c.board_points,
                                      c.image_size, c.fps)
    j_imu = j_types.ImuData(tel.imu.times, tel.imu.accel, tel.imu.gyro)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ba_j, bg_j, src_j = j_sew.estimate_static_biases(j_imu)
    pj = j_pe.estimate_poses(j_corners, j_types.CameraCalibration(**calib))
    sj = j_sew.compute_sew(j_imu, j_corners.fps or 30.0)
    ij = j_rot.estimate_imu_to_camera_rotation(pj, j_imu)

    assert src_t == src_j
    np.testing.assert_allclose(np.r_[ba_t, bg_t], np.r_[ba_j, bg_j], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(pt.valid, pj.valid)
    v = pt.valid
    assert v.mean() > 0.8
    s = np.sign(np.sum(pt.q_w_c * pj.q_w_c, -1, keepdims=True))
    np.testing.assert_allclose((s * pt.q_w_c)[v], pj.q_w_c[v], atol=1e-6)
    np.testing.assert_allclose(pt.t_w_c[v], pj.t_w_c[v], atol=1e-6)
    for k in ("dt_so3", "dt_r3", "std_so3", "std_r3", "cam_fps"):
        assert getattr(st, k) == pytest.approx(getattr(sj, k), rel=1e-12, abs=0), k
    assert abs(it.time_offset - ij.time_offset) < t_rot.RotationEstimatorOptions().tol_s
    s = np.sign(np.dot(it.q_gyro_to_cam, ij.q_gyro_to_cam))
    np.testing.assert_allclose(s * it.q_gyro_to_cam, ij.q_gyro_to_cam, atol=1e-6)
    np.testing.assert_allclose(it.gyro_bias, ij.gyro_bias, atol=1e-6)
    print(f"line delay {line_delay:.3e} s: time offset error {it.time_offset - TIME_OFFSET:+.6f} s "
          f"(port), {ij.time_offset - TIME_OFFSET:+.6f} s (JAX)")
    if line_delay == 0.0:
        assert abs(it.time_offset - TIME_OFFSET) < 0.004


@pytest.fixture(scope="module")
def cli_run(workspace, tmp_path_factory):
    """(summary, the stage-8 inputs run_calibration handed over, its
    workspace) of one run with --optimize_board_points, in a copy of the
    seeded workspace."""
    sc, ws, tel = workspace
    w = str(tmp_path_factory.mktemp("cli"))
    for f in ("cam_corners.uson", "imu_cam_corners.uson"):
        shutil.copy(os.path.join(ws, f), w)
    captured = {}
    real = t_icc.calibrate_imu_camera

    def spy(corners, calib, poses, imu, init, sew, **kw):
        captured.update(corners=corners, calib=calib, poses=poses, init=init, sew=sew, kw=kw)
        return real(corners, calib, poses, imu, init, sew, **kw)

    t_icc.calibrate_imu_camera = spy
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            summary = t_run.main(_argv(w, tel, "--device", "cpu", "--voxel_grid_size", "0.01",
                                       "--optimize_board_points"))
    finally:
        t_icc.calibrate_imu_camera = real
    return summary, captured, w


def test_run_calibration_recovers_the_truth(workspace, cli_run):
    sc = workspace[0]
    s, captured, ws = cli_run
    for f in ("cam_corners.uson", "imu_cam_corners.uson", "cam_calib.json",
              "imu_cam_result.json", "summary.json"):
        assert os.path.exists(os.path.join(ws, f)), f
    with open(os.path.join(ws, "summary.json")) as f:
        assert json.load(f) == json.loads(json.dumps(s))
    assert s["camera_model"] == "division_undistortion" and s["bias_estimate"] == "none"
    assert s["intrinsics_reproj_error_px"] < 0.35
    assert abs(s["intrinsics_params"][0] - CAM[0]) < 2.0
    assert abs(s["time_offset_s"] - TIME_OFFSET) < 2e-3
    assert np.all(np.abs(np.asarray(s["t_i_c"]) - sc.t_i_c) < 5e-3)
    q, qt = np.asarray(s["q_i_c"]), sc.q_i_c
    assert 2 * np.arccos(min(1.0, abs(float(np.dot(q, qt))))) < 0.01
    assert abs(np.linalg.norm(s["gravity"]) - 9.81) < 0.05
    assert s["final_reproj_error_px"] < 0.35
    assert set(s["stage_timings_s"]) >= {"1. intrinsic calibration", "5. pose estimation",
                                         "8. continuous-time batch calibration"}
    # --optimize_board_points: refined points and their covariances reach stage 8.
    kw = captured["kw"]
    assert kw["optimize_board_points"] and kw["reproj_cov"] is not None
    np.testing.assert_array_equal(captured["corners"].board_points,
                                  captured["poses"].board_points)


def test_run_calibration_hands_stage_8_the_library_chain(workspace, cli_run):
    """The CLI's poses, init and SEW are those of the library chain run on
    the CLI's own calibration and inputs."""
    _, captured, ws = cli_run
    calib = t_io.load_camera_calibration(os.path.join(ws, "cam_calib.json"))
    corners = t_io.load_corners(os.path.join(ws, "imu_cam_corners.uson"))
    _, poses, sew, init = _port_chain(corners, calib, t_tel.read_generic_json(workspace[2]).imu)
    np.testing.assert_array_equal(captured["calib"].params, calib.params)
    np.testing.assert_array_equal(captured["poses"].valid, poses.valid)
    np.testing.assert_array_equal(captured["poses"].q_w_c, poses.q_w_c)
    assert captured["sew"] == sew
    assert captured["init"].time_offset == init.time_offset
    np.testing.assert_array_equal(captured["init"].q_gyro_to_cam, init.q_gyro_to_cam)
    np.testing.assert_array_equal(captured["init"].gyro_bias, init.gyro_bias)


@pytest.mark.parametrize("extra, error, match", [
    # the multi-process flags are ported (tests/test_torch_multihost.py): a
    # rank outside the world is refused before any connection is tried
    (["--coordinator_address", "127.0.0.1:1", "--num_processes", "2", "--process_id", "2"],
     ValueError, "process_id"),
    (["--detector_kernel", "pallas"], ValueError, "only 'auto'"),
    # GoPro MP4 telemetry is ported (tests/test_torch_gpmf.py,
    # test_torch_recorded.py): a missing MP4 is reported by name
    (["--telemetry_format", "gopro", "--telemetry_json", "rec.MP4"], FileNotFoundError,
     "rec.MP4"),
    # charuco (the default board) is ported: detecting again means decoding
    # the video, which needs cv2, as does the OpenCV backend
    (["--board_type", "charuco", "--recompute_corners"], ImportError, "cv2"),
    (["--detector_backend", "opencv", "--recompute_corners"], ImportError, "cv2"),
], ids=["multi-process", "detector-kernel", "gopro-mp4", "charuco", "opencv"])
def test_run_calibration_rejects_what_is_not_ported(workspace, tmp_path, monkeypatch, extra,
                                                    error, match):
    """What the port refuses raises and says why; what
    needs cv2 says so where cv2 is not installed (simulated here); a GoPro
    MP4 that is not there is named."""
    _, ws, tel = workspace
    w = str(tmp_path)
    for f in ("cam_corners.uson", "imu_cam_corners.uson"):
        shutil.copy(os.path.join(ws, f), w)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(error, match=match):
        t_run.main(_argv(w, tel, "--device", "cpu") + extra)
