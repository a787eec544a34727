"""The benchmark's frozen copies (``benchmarks/gen``, ``harness/peaks``)
held equal to the port's functions they were copied from, at tiny sizes on
the CPU. A failure here means the port's generator or formats moved: the
benchmark keeps its copy; the port's change is what needs a look."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmarks.gen import files, frames, scene
from benchmarks.harness import peaks
from openimucameracalibrator_torch.core import telemetry
from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.utils import io, recorded, synthetic
from openimucameracalibrator_torch.utils.types import CameraTelemetry, CornerDataset, ImuData

DS3 = [437.13, 489.07, 270.87, -1.4386e-06]
DS5 = [342.43, 342.43, 472.60, 273.88, -0.215, 0.5129]
MODELS = [("division_undistortion", DS3), ("double_sphere", DS5)]


def _same_scene(ours, port):
    for f in ("frame_times", "q_w_c", "t_w_c", "observations", "obs_valid"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(port, f), err_msg=f)
    np.testing.assert_array_equal(ours.board_points, port.board.points)


@pytest.mark.parametrize("model,cam", MODELS)
def test_intrinsics_scene_is_the_ports(model, cam):
    ours = scene.make_intrinsics_scene(model, cam, num_views=12, seed=4, device="cpu")
    port = synthetic.make_intrinsics_scene(cameras.get_model(model), cam, num_views=12, seed=4,
                                           device="cpu")
    _same_scene(ours, port)


@pytest.mark.parametrize("model,cam", MODELS)
@pytest.mark.parametrize("line_delay", [0.0, 30.895e-6])
def test_imu_camera_scene_is_the_ports(model, cam, line_delay):
    kw = dict(duration=2.0, cam_fps=10.0, imu_rate=50.0, time_offset=-0.0815,
              line_delay=line_delay, seed=6, device="cpu")
    ours = scene.make_imu_camera_scene(model, cam, **kw)
    port = synthetic.make_imu_camera_scene(cameras.get_model(model), cam, **kw)
    _same_scene(ours, port)
    for f in ("imu_times", "accel", "gyro", "q_i_c", "t_i_c"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(port, f), err_msg=f)


def test_corner_file_and_telemetry_are_the_ports(tmp_path):
    s = scene.make_imu_camera_scene("division_undistortion", DS3, duration=1.0, cam_fps=10.0,
                                    imu_rate=50.0, seed=2, device="cpu")
    files.write_corners(str(tmp_path / "ours.uson"), s.frame_times, s.observations,
                        s.obs_valid, s.board_points, s.image_size, 60.0)
    io.save_corners(CornerDataset(s.frame_times, s.observations, s.obs_valid, s.board_points,
                                  s.image_size, 60.0), str(tmp_path / "port.uson"))
    assert (tmp_path / "ours.uson").read_bytes() == (tmp_path / "port.uson").read_bytes()
    files.write_generic_telemetry(str(tmp_path / "ours.json"), s.imu_times, s.accel, s.gyro,
                                  60.0)
    telemetry.write_generic_json(CameraTelemetry(imu=ImuData(s.imu_times, s.accel, s.gyro)),
                                 str(tmp_path / "port.json"), cam_fps=60.0)
    assert (json.loads((tmp_path / "ours.json").read_text())
            == json.loads((tmp_path / "port.json").read_text()))


def test_charuco_texture_is_the_ports():
    ours = frames.charuco_texture(px_per_square=16, margin_px=8)
    port = recorded.charuco_texture(10, 8, 0.04, 0.03, 16, 8)
    np.testing.assert_array_equal(ours.image, port.image)


@pytest.mark.parametrize("model,cam", MODELS)
def test_rendered_frames_are_the_ports_without_noise(model, cam):
    """A 96x54 camera (the configuration's, scaled by 1/10) along the
    recording trajectory; float32 as on the card."""
    cam = np.asarray(cam, np.float64)
    cam[: (3 if model == "division_undistortion" else 4)] /= 10.0
    if model == "division_undistortion":
        cam[3] *= 100.0
    q_i_c = scene.rig_rotation("cpu").numpy()
    pose = scene.sinusoid_trajectory(np.random.default_rng(3), rot_amp=0.22, pos_amp=0.08,
                                     pos_center=(0.2, 0.16, -0.46),
                                     q_base=scene.quat_conjugate(torch.as_tensor(q_i_c)).numpy(),
                                     device="cpu")
    tex = frames.charuco_texture(px_per_square=16, margin_px=8)
    stamps = np.arange(3) / 60.0
    kw = dict(time_offset=-0.08, line_delay=3e-4, supersample=2)
    ours = frames.render_frames(pose, stamps, model, cam, q_i_c, [0.01, -0.02, 0.001], tex,
                                (96, 54), noise_std=0.0, device="cpu", **kw).numpy()
    port = recorded.render_frames(pose, stamps, model, cam, q_i_c, [0.01, -0.02, 0.001],
                                  recorded.charuco_texture(10, 8, 0.04, 0.03, 16, 8), (96, 54),
                                  noise_std=0.0, device="cpu", dtype=torch.float32, **kw)
    np.testing.assert_array_equal(ours, np.stack(port))
    assert ours.std() > 10  # the board is in view


def test_kernel_work_is_the_yardstick_the_kernel_table_used():
    """K1: chip_smoke.gram_bound's bytes and operations; K2's block mode:
    236 operations per pixel at radius 6, 8 bytes per pixel."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import chip_smoke

    for shape in [(56, 8192, 44, 173, 2), (47, 768, 54, 216, 1), (224, 8192, 44, 233, 2)]:
        assert peaks.gram_work(*shape) == tuple(chip_smoke.gram_bound(*shape)[3:5])
    nbytes, ops = peaks.corner_block_work(32, 540, 960)
    assert (nbytes, ops) == (32 * 540 * 960 * 8, 32 * 540 * 960 * 236)
