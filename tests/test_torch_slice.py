"""The port's stage-8 slice as a whole, against the JAX package.

* The JAX CLI and the torch CLI (``--device cpu``, float64) run on the
  same input artifacts, written from a small synthetic scene (3 s at
  10 fps, 100 Hz IMU; division-undistortion camera), for global and
  rolling shutter, with capped iterations. Their result jsons agree:
  extrinsics, time offset, line delay, gravity, the bias splines, the
  mean reprojection error, and the solver trace (iteration count, status,
  cost history). Tolerance 1e-7 relative (float64 on both sides; the
  difference is summation order inside a dozen LM steps).
* Corner ``.uson`` and pose ``.calibdata`` artifacts round-trip between
  the two packages' writers and readers.
* The port imports no JAX, and its entry points run on CUDA unless told
  otherwise.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.apps import continuous_time_calibration as t_cli
from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.utils import io as t_io
from openimucameracalibrator_torch.utils import synthetic
from openimucameracalibrator_torch.utils import theia_io as t_theia
from openimucameracalibrator_torch.utils import types as t_types
from openimucameracalibrator_tpu.apps import continuous_time_calibration as j_cli
from openimucameracalibrator_tpu.utils import io as j_io
from openimucameracalibrator_tpu.utils import theia_io as j_theia
from openimucameracalibrator_tpu.utils import types as j_types

FPS = 10.0
RTOL = 1e-7


def _scene(line_delay):
    return synthetic.make_imu_camera_scene(
        cameras.get_model("division_undistortion"), [437.13, 489.07, 270.87, -1.4386e-06],
        duration=3.0, cam_fps=FPS, imu_rate=100.0, time_offset=-0.0813,
        line_delay=line_delay, seed=3, device="cpu")


@pytest.mark.parametrize("shutter", ["global", "rolling"])
def test_cli_result_matches_jax(shutter, tmp_path):
    # Rolling shutter: the CLI starts from 1/fps/rows = 185 us; truth 150 us.
    sc = _scene(0.0 if shutter == "global" else 150e-6)
    paths = synthetic.write_stage8_inputs(sc, str(tmp_path), cam_fps=FPS, dt_so3=0.1,
                                          dt_r3=0.1, std_so3=0.002, std_r3=0.02)
    argv = sum([[f"--{k}", v] for k, v in paths.items()], [])
    argv += ["--max_iters", "6", "--line_delay_iters", "4"]
    if shutter == "global":
        argv.append("--global_shutter")
    out_j, out_t = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    j_cli.run(j_cli.build_parser().parse_args(argv + ["--output_path", out_j]))
    t_cli.main(argv + ["--output_path", out_t, "--device", "cpu"])
    a, b = j_io.load_imu_camera_result(out_j), t_io.load_imu_camera_result(out_t)

    def close(x, y, what):
        np.testing.assert_allclose(np.asarray(y, float), np.asarray(x, float), rtol=RTOL,
                                   atol=1e-12, err_msg=what)

    for k in ("q_i_c", "t_i_c", "gravity"):
        close(list(a[k].values()), list(b[k].values()), k)
    for k in ("time_offset_imu_to_cam_s", "cam_line_delay", "final_reproj_error",
              "final_cost", "cost_history"):
        close(a[k], b[k], k)
    assert (b["iterations"], b["solver_status"]) == (a["iterations"], a["solver_status"])
    assert b["trajectory"].keys() == a["trajectory"].keys()
    for key in list(a["trajectory"])[::25]:
        for field in ("accl_bias", "gyro_bias", "accl_spline", "gyro_spline"):
            close(list(a["trajectory"][key][field].values()),
                  list(b["trajectory"][key][field].values()), f"{key} {field}")
    if shutter == "rolling":
        assert b["cam_line_delay"] != pytest.approx(1.0 / FPS / 540)  # it was refined


def test_corner_and_pose_artifacts_round_trip(tmp_path, rng):
    V, P = 5, 12
    valid = rng.uniform(size=(V, P)) > 0.2
    corners = dict(times=np.arange(V) * 0.1 + 0.05, points2d=rng.uniform(0, 500, (V, P, 2)) * valid[..., None],
                   valid=valid, board_points=np.c_[rng.uniform(0, 0.3, (P, 2)), np.zeros(P)],
                   image_size=(960, 540), fps=10.0)
    for ext in (".uson", ".json"):
        p1, p2 = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
        t_io.save_corners(t_types.CornerDataset(**corners), p1)
        j_io.save_corners(j_types.CornerDataset(**corners), p2)
        for path in (p1, p2):
            for back in (t_io.load_corners(path), j_io.load_corners(path)):
                np.testing.assert_array_equal(back.valid, valid)
                np.testing.assert_allclose(back.points2d[valid], corners["points2d"][valid])
                np.testing.assert_allclose(back.times, corners["times"], atol=1e-6)
    q = rng.normal(size=(V, 4))
    poses = dict(times=corners["times"], q_w_c=q / np.linalg.norm(q, axis=1, keepdims=True),
                 t_w_c=rng.normal(size=(V, 3)), valid=np.ones(V, bool),
                 board_points=corners["board_points"])
    calib = dict(model_name="division_undistortion",
                 params=np.array([437.13, 489.07, 270.87, -1.4386e-06]), image_size=(960, 540),
                 mean_reproj_error=0.2, fps=10.0)
    pt, pj = str(tmp_path / "t.calibdata"), str(tmp_path / "j.calibdata")
    t_theia.save_pose_dataset_calibdata(pt, t_types.PoseDataset(**poses),
                                        t_types.CameraCalibration(**calib))
    j_theia.save_pose_dataset_calibdata(pj, j_types.PoseDataset(**poses),
                                        j_types.CameraCalibration(**calib))
    with open(pt, "rb") as f1, open(pj, "rb") as f2:
        assert f1.read() == f2.read()
    for reader in (t_theia.load_pose_dataset_calibdata, j_theia.load_pose_dataset_calibdata):
        back, cal, _ = reader(pt)
        np.testing.assert_allclose(np.abs(np.sum(back.q_w_c * poses["q_w_c"], 1)), 1.0, atol=1e-9)
        np.testing.assert_allclose(back.t_w_c, poses["t_w_c"], atol=1e-9)
        np.testing.assert_allclose(cal.params, calib["params"], rtol=1e-12)


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in JAX or the JAX package."""
    code = """
import importlib, pkgutil, sys
import openimucameracalibrator_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "openimucameracalibrator_tpu")))
assert not bad, bad
assert len(names) >= 49, names
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda(tmp_path):
    """Without ``device`` the entry points ask for CUDA and raise where
    there is none; they never fall back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from openimucameracalibrator_torch.core import imu_camera_calibrator, spline_estimator
    from openimucameracalibrator_torch.utils import convert

    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.make_imu_camera_scene(cameras.get_model("pinhole"), [400.0, 400, 480, 270])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_numpy({"gravity": np.zeros(3)})
    corners = t_types.CornerDataset(np.zeros(2), np.zeros((2, 3, 2)), np.ones((2, 3), bool),
                                    np.zeros((3, 3)), (960, 540))
    with pytest.raises(RuntimeError, match="CUDA"):
        imu_camera_calibrator.calibrate_imu_camera(corners, None, None, None, None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        spline_estimator.build_problem(corners, None, None, None, 0.0, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["--input_corners", "x", "--camera_calibration_json", "x",
                    "--input_pose_dataset", "x", "--telemetry_json", "x",
                    "--imu_rotation_init", "x", "--spline_weighting_json", "x",
                    "--output_path", str(tmp_path / "r.json")])
    # The multi-process flags are ported: a rank outside the world is refused
    # before any connection is tried.
    with pytest.raises(ValueError, match="process_id"):
        t_cli.main(["--input_corners", "x", "--camera_calibration_json", "x",
                    "--input_pose_dataset", "x", "--telemetry_json", "x",
                    "--imu_rotation_init", "x", "--spline_weighting_json", "x",
                    "--output_path", "x", "--coordinator_address", "127.0.0.1:1",
                    "--num_processes", "2", "--process_id", "2", "--device", "cpu"])

    # The intrinsics slice: extract_board, calibrate_camera, both CLIs,
    # render_frames, make_intrinsics_scene and detect_checkerboard.
    from openimucameracalibrator_torch.apps import calibrate_camera as cal_cli
    from openimucameracalibrator_torch.apps import extract_board as ext_cli
    from openimucameracalibrator_torch.core import board_extractor, camera_calibrator
    from openimucameracalibrator_torch.detect import checkerboard, render
    from openimucameracalibrator_torch.utils import recorded

    frame = render.render_checkerboard(8, 6, 50, 25)
    opts = board_extractor.BoardExtractorOptions(board_type="radon", squares_x=8, squares_y=6)
    tex = recorded.BoardTexture(frame, 50, 25, 0.04)
    calls = [
        lambda: board_extractor.extract_board([(0.0, frame)], opts),
        lambda: camera_calibrator.calibrate_camera(corners, "pinhole"),
        lambda: cal_cli.main(["--input_corners", "x", "--save_path_calib_dataset", "x"]),
        lambda: ext_cli.main(["--input_path", str(tmp_path), "--board_type", "radon",
                              "--save_corners_to_path", str(tmp_path / "c.uson")]),
        lambda: recorded.render_frames(lambda t: None, [0.0], "pinhole", [400.0, 400, 80, 60],
                                       [1.0, 0, 0, 0], [0.0, 0, 0], tex, (160, 120)),
        lambda: synthetic.make_intrinsics_scene(cameras.get_model("pinhole"),
                                                [400.0, 400, 480, 270]),
        lambda: checkerboard.detect_checkerboard(frame, 8, 6),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # The marker boards are ported: on the plain checkerboard they find
    # nothing, on the CPU when asked.
    for bt in ("charuco", "apriltag"):
        ds = board_extractor.extract_board([(0.0, frame)], board_extractor.BoardExtractorOptions(
            board_type=bt), device="cpu")
        assert ds.num_views == 1 and int(ds.valid.sum()) == 0

    # The stage-8 inputs: pose estimation, board-point refinement, the
    # rotation / time-offset init, their CLIs and the pipeline CLI.
    from openimucameracalibrator_torch.apps import estimate_imu_to_camera_rotation as rot_cli
    from openimucameracalibrator_torch.apps import estimate_poses as pose_cli
    from openimucameracalibrator_torch.apps import run_calibration
    from openimucameracalibrator_torch.core import imu_cam_rotation, pose_estimator

    calib = t_types.CameraCalibration("pinhole", np.array([400.0, 400, 480, 270]), (960, 540),
                                      0.0)
    poses = t_types.PoseDataset(np.zeros(2), np.tile([1.0, 0, 0, 0], (2, 1)), np.zeros((2, 3)),
                                np.ones(2, bool), np.zeros((3, 3)))
    imu = t_types.ImuData(np.arange(3.0), np.zeros((3, 3)), np.zeros((3, 3)))
    calls = [
        lambda: pose_estimator.estimate_poses(corners, calib),
        lambda: pose_estimator.optimize_board_points(corners, calib, poses),
        lambda: imu_cam_rotation.estimate_imu_to_camera_rotation(poses, imu),
        lambda: pose_cli.main(["--input_corners", "x", "--camera_calibration_json", "x",
                               "--output_pose_dataset", "x"]),
        lambda: rot_cli.main(["--telemetry_json", "x", "--input_pose_dataset", "x",
                              "--imu_rotation_init_output", "x"]),
        lambda: run_calibration.main(["--path_calib_dataset", str(tmp_path),
                                      "--telemetry_json", "x"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
