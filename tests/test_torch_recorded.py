"""The port's recorded-data harness (``utils/recorded.make_recording``) and
the GoPro MP4 path of ``run_calibration``.

* ``make_recording`` with every noise at 0 at a tiny size, the JAX
  package's trajectory draws fed to the port (its own are numpy's): the
  rendered frames within 1 DN (uint8 truncation of float64 renders that
  agree to ~1e-12), the IMU readings and CORI quaternions handed to the
  muxer to 1e-9 absolute (the same analytic derivatives through
  ``torch.func.jvp`` and ``jax.jvp``).
* The GPMF round trip of the port's ``imu_cam.MP4``: the reader returns
  what was muxed (float32 samples: equal to float32 rounding) on the
  video track's frame clock.
* The entry points raise without CUDA unless given ``device="cpu"``, and
  the plotting tools name matplotlib when it is missing.
* ``slow``: ``run_calibration --telemetry_format gopro`` on the CPU from
  the port's MP4s (cv2 decodes the video), held to the bars of
  ``tests/test_recorded_e2e.py`` with its ``REC_KW`` (the JAX
  ``run_calibration`` cannot be imported: its board extractor imports
  ``detect/quads.py``, which does not parse, so the bars stand in for it).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_tpu.utils import diagnostics as j_diagnostics
from openimucameracalibrator_tpu.utils import recorded as j_recorded
from openimucameracalibrator_torch.apps import export_for_kalibr, misc_tools, run_calibration
from openimucameracalibrator_torch.core import (camera_calibrator, gpmf, static_imu_calibrator,
                                                telemetry)
from openimucameracalibrator_torch.ops import allan
from openimucameracalibrator_torch.utils import diagnostics, recorded, synthetic

TINY = dict(image_size=(160, 90), duration=1.0, cam_fps=4.0, intrinsics_frames=2,
            imu_rate=50.0, squares_x=4, squares_y=3, square_length=0.06,
            marker_length=0.045, seed=3, line_delay=1e-4)
NO_NOISE = dict(noise_std=0.0, accel_noise=0.0, gyro_noise=0.0)


def _spy(monkeypatch, module, name, store):
    real = getattr(module, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        store.append((a, kw, out))
        return out

    monkeypatch.setattr(module, name, spy)


def _jax_draws(monkeypatch):
    """Make the port's sinusoid_trajectory draw what jax.random draws for
    the JAX package's key of the same seed (k1..k4 of split(key, 4))."""
    real = synthetic.sinusoid_trajectory

    class Replay:
        def __init__(self, seed, nh):
            keys = jax.random.split(jax.random.PRNGKey(seed), 4)
            lims = [(-1.0, 1.0), (0.0, 2 * np.pi)] * 2
            self.draws = [np.array(jax.random.uniform(k, (nh, 3), jnp.float64, lo, hi))
                          for k, (lo, hi) in zip(keys, lims)]

        def uniform(self, lo, hi, shape):
            return self.draws.pop(0)

    def traj(rng, duration, **kw):
        return real(Replay(int(rng.bit_generator.seed_seq.entropy), kw.get("n_harmonics", 3)),
                    duration, **kw)

    monkeypatch.setattr(recorded.synthetic, "sinusoid_trajectory", traj)


def test_make_recording_matches_jax(tmp_path, monkeypatch):
    _jax_draws(monkeypatch)
    got_frames, want_frames, got_imu, want_imu = [], [], [], []
    _spy(monkeypatch, recorded, "render_frames", got_frames)
    _spy(monkeypatch, j_recorded, "render_frames", want_frames)
    _spy(monkeypatch, recorded.mp4_writer, "make_imu_payloads", got_imu)
    _spy(monkeypatch, j_recorded.mp4_writer, "make_imu_payloads", want_imu)
    got = recorded.make_recording(str(tmp_path / "t"), **TINY, **NO_NOISE, device="cpu")
    want = j_recorded.make_recording(str(tmp_path / "j"), **TINY, **NO_NOISE)
    for k in ("cam_params", "q_i_c", "t_i_c", "accel_bias", "gyro_bias"):
        np.testing.assert_allclose(getattr(got, k), np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-15, err_msg=k)
    assert (got.model_name, got.image_size, got.time_offset, got.line_delay) == (
        want.model_name, want.image_size, want.time_offset, want.line_delay)
    assert [len(o) for *_, o in got_frames] == [len(o) for *_, o in want_frames] == [2, 3]
    for (_, _, g), (_, _, w) in zip(got_frames, want_frames):
        for a, b in zip(g, w):
            assert a.dtype == np.uint8 and a.shape == (90, 160)
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert np.mean(np.concatenate(g) != 170) > 0.1  # the board is in view
    (ga, gkw, _), (wa, wkw, _) = got_imu[0], want_imu[0]
    for x, y in zip(ga, wa):  # times, accel, gyro
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-9)
    np.testing.assert_allclose(gkw["cam_quats"], wkw["cam_quats"], rtol=0, atol=1e-9)
    # Both files carry the same telemetry (float32 samples).
    tg, tw = gpmf.read_gopro_mp4(got.imu_cam_video), gpmf.read_gopro_mp4(want.imu_cam_video)
    np.testing.assert_array_equal(tg.imu.times, tw.imu.times)
    np.testing.assert_array_equal(tg.img_times, tw.img_times)
    for k in ("accel", "gyro"):
        np.testing.assert_allclose(getattr(tg.imu, k), getattr(tw.imu, k), rtol=0, atol=1e-5)


def test_recording_gpmf_round_trip(tmp_path, monkeypatch):
    """The port's imu_cam.MP4 gives back what was muxed: IMU on its clock,
    CORI in (w, x, y, z), the video track's frame times; the noise is
    seeded (the same seed gives the same file)."""
    muxed = []
    _spy(monkeypatch, recorded.mp4_writer, "make_imu_payloads", muxed)
    rec = recorded.make_recording(str(tmp_path / "a"), **TINY, device="cpu")
    (times, accel, gyro), kw, _ = muxed[0]
    tel = gpmf.read_gopro_mp4(rec.imu_cam_video)
    np.testing.assert_allclose(tel.imu.times, times, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tel.imu.accel, accel.astype(np.float32))
    np.testing.assert_array_equal(tel.imu.gyro, gyro.astype(np.float32))
    np.testing.assert_array_equal(tel.cam_quats, kw["cam_quats"].astype(np.float32))
    n_frames = int(TINY["duration"] * TINY["cam_fps"]) - 1
    np.testing.assert_allclose(tel.img_times, np.arange(n_frames) / TINY["cam_fps"], atol=1e-9)
    assert abs(tel.imu.rate_hz - TINY["imu_rate"]) < 1e-6
    assert np.std(accel - np.mean(accel, 0)) > 0  # the IMU noise is on
    rec2 = recorded.make_recording(str(tmp_path / "b"), **TINY, device="cpu")
    with open(rec.imu_cam_video, "rb") as f1, open(rec2.imu_cam_video, "rb") as f2:
        assert f1.read() == f2.read()


def test_entry_points_need_cuda_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imu = synthetic.make_multipose_imu(np.random.default_rng(0), n_poses=2)
    calls = [
        lambda d: recorded.make_recording(str(tmp_path), **TINY, imu_cam=False, device=d),
        lambda d: static_imu_calibrator.calibrate_accelerometer(np.eye(3) * 9.81, device=d),
        lambda d: allan.analyze(imu.gyro, 100.0, device=d),
        lambda d: camera_calibrator.calibrate_camera_batch([], device=d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
    calls[0]("cpu")
    calls[1]("cpu")
    tel = str(tmp_path / "t.json")
    telemetry.write_generic_json(telemetry.CameraTelemetry(imu=imu), tel)
    for main in (misc_tools.static_imu_main, misc_tools.allan_main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--telemetry_json", tel, "--output_path", str(tmp_path / "o.json")])


def test_plotting_tools_name_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    result = tmp_path / "result.json"
    result.write_text(json.dumps({"trajectory": {"0": {}}}))
    with pytest.raises(ImportError, match="matplotlib"):
        misc_tools.result_stats_main(["--path_results", str(result)])
    dump = tmp_path / "init.json"
    dump.write_text(json.dumps({"debug_visual_ang_vel": [[0.0, 0.0, 0.0]],
                                "debug_imu_ang_vel_transformed": [[0.0, 0.0, 0.0]]}))
    with pytest.raises(ImportError, match="matplotlib"):
        misc_tools.debug_calib_main(["--rotation_init_json", str(dump)])
    with pytest.raises(ImportError, match="matplotlib"):
        diagnostics.pyplot()


def test_debug_calib_and_result_stats_plot(tmp_path):
    pytest.importorskip("matplotlib")
    dump = tmp_path / "init.json"
    w = np.random.default_rng(0).normal(size=(30, 3)).tolist()
    dump.write_text(json.dumps({"debug_visual_ang_vel": w, "debug_imu_ang_vel_transformed": w}))
    misc_tools.debug_calib_main(["--rotation_init_json", str(dump)])
    assert os.path.getsize(str(dump) + ".png") > 0
    traj = {str(int(k * 1e7)): {f"{s}_{kind}": dict(zip("xyz", np.random.rand(3).tolist()))
                               for s in ("accl", "gyro") for kind in ("imu", "spline", "bias")}
            for k in range(20)}
    result = tmp_path / "result.json"
    result.write_text(json.dumps({"trajectory": traj, "final_reproj_error": 0.3}))
    misc_tools.result_stats_main(["--path_results", str(result)])
    assert os.path.getsize(str(result) + ".png") > 0


def test_export_for_kalibr(tmp_path, monkeypatch):
    """Frames named by their decode time in ns + the IMU csv; without cv2
    the tool names it."""
    pytest.importorskip("cv2")
    rec = recorded.make_recording(str(tmp_path / "ds"), **TINY, device="cpu")
    tel_path = str(tmp_path / "tel.json")
    telemetry.write_generic_json(gpmf.read_gopro_mp4(rec.imu_cam_video), tel_path)
    out = tmp_path / "kalibr"
    export_for_kalibr.main(["--video", rec.imu_cam_video, "--telemetry_json", tel_path,
                            "--output_dir", str(out), "--subsample", "2"])
    names = sorted(os.listdir(out / "cam0"), key=lambda n: int(n[:-4]))
    assert names == [f"{int(round(k / TINY['cam_fps'] * 1e9))}.png" for k in (0, 2)]
    assert len((out / "imu0.csv").read_text().strip().splitlines()) == 50  # 1 s at 50 Hz
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        export_for_kalibr.main(["--video", rec.imu_cam_video, "--telemetry_json", tel_path,
                                "--output_dir", str(out)])


def test_orientation_stream_study_and_ply_match_jax(tmp_path):
    """diagnostics.evaluate_camera_orientation_stream and
    export_calibration_ply against the JAX package's (float64, 1e-9)."""
    from openimucameracalibrator_tpu.utils import types as j_types
    from openimucameracalibrator_torch.utils import types as t_types

    rng = np.random.default_rng(2)
    t = np.linspace(0.0, 2.0, 41)
    q = np.cumsum(rng.normal(size=(41, 4)) * 0.05, axis=0) + [1.0, 0.0, 0.0, 0.0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pose = dict(times=t[::2], q_w_c=q[::2], t_w_c=rng.normal(size=(21, 3)),
                valid=np.arange(21) % 5 != 3, board_points=np.zeros((4, 3)))
    got = diagnostics.evaluate_camera_orientation_stream(q, t, t_types.PoseDataset(**pose))
    want = j_diagnostics.evaluate_camera_orientation_stream(q, t, j_types.PoseDataset(**pose))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12, err_msg=k)
    details = dict(q_cw=pose["q_w_c"], t_cw=pose["t_w_c"])
    board = rng.normal(size=(6, 3))
    diagnostics.export_calibration_ply(details, board, str(tmp_path / "t.ply"))
    j_diagnostics.export_calibration_ply(details, board, str(tmp_path / "j.ply"))
    rows_t = (tmp_path / "t.ply").read_text().splitlines()
    rows_j = (tmp_path / "j.ply").read_text().splitlines()
    assert rows_t[:10] == rows_j[:10] and len(rows_t) == len(rows_j) == 10 + 6 + 21
    for a, b in zip(rows_t[10:], rows_j[10:]):
        np.testing.assert_allclose(np.array(a.split(), float), np.array(b.split(), float),
                                   rtol=1e-12, atol=1e-12)


# tests/test_recorded_e2e.py's recording (its REC_KW).
REC_KW = dict(duration=9.0, cam_fps=10.0, intrinsics_frames=24,
              image_size=(640, 360), time_offset=-0.08,
              squares_x=8, squares_y=6, square_length=0.06,
              marker_length=0.045, seed=3)


@pytest.mark.slow
def test_run_calibration_from_gopro_mp4(tmp_path):
    """The user's path on the CPU: MP4 files in, calibration out (video
    decoded by cv2, telemetry from the GPMF track), held to the bars of
    tests/test_recorded_e2e.py:63-93."""
    pytest.importorskip("cv2")
    rec = recorded.make_recording(str(tmp_path / "ds"), **REC_KW, device="cpu")
    summary = run_calibration.main([
        "--path_calib_dataset", os.path.dirname(rec.cam_video),
        "--telemetry_json", rec.imu_cam_video, "--telemetry_format", "gopro",
        "--num_squares_x", "8", "--num_squares_y", "6",
        "--checker_size_m", "0.06", "--marker_size_m", "0.045",
        "--global_shutter", "--workspace", str(tmp_path / "ws"), "--device", "cpu"])
    assert summary["intrinsics_reproj_error_px"] < 0.31
    got, gt = np.asarray(summary["intrinsics_params"]), rec.cam_params
    assert abs(got[0] - gt[0]) / gt[0] < 0.01
    assert abs(got[1] - gt[1]) < 2.0 and abs(got[2] - gt[2]) < 2.0
    assert abs(summary["time_offset_s"] - rec.time_offset) < 3e-3
    assert np.all(np.abs(np.asarray(summary["t_i_c"]) - rec.t_i_c) < 5e-3)
    q = np.asarray(summary["q_i_c"])
    assert 2 * np.arccos(min(1.0, abs(float(np.dot(q, rec.q_i_c))))) < np.deg2rad(0.5)
    assert summary["final_reproj_error_px"] < 2.0
    g = np.asarray(summary["gravity"])
    assert abs(np.linalg.norm(g) - 9.81) < 0.05 and g[2] > 9.7
    for f in ("cam_corners.uson", "imu_cam_corners.uson", "cam_calib.json",
              "imu_cam_result.json", "summary.json"):
        assert os.path.exists(tmp_path / "ws" / f), f
