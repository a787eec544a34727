"""Port parity: the IMU side of the stage-8 inputs against the JAX package.

Host modules (numpy/scipy, copied into the port): ``ops/intervals.py``,
``ops/sew.py`` (SEW knot spacings and static biases), ``core/telemetry.py``
(every importer and writer) and the two tools of ``apps/misc_tools.py``
they serve: equal to the JAX package's to 1e-12 (the same numpy code).
Device module: ``core/imu_cam_rotation.py`` on the CPU in float64 against
the JAX function (jitted, x64) on the same poses and IMU record: time
offset within the search tolerance ``tol_s`` = 1e-4 s, rotation and gyro
bias within 1e-6.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest

from openimucameracalibrator_torch.apps import estimate_imu_to_camera_rotation as t_rot_cli
from openimucameracalibrator_torch.apps import misc_tools as t_misc
from openimucameracalibrator_torch.core import imu_cam_rotation as t_rot
from openimucameracalibrator_torch.core import pose_estimator as t_pe
from openimucameracalibrator_torch.core import telemetry as t_tel
from openimucameracalibrator_torch.models import cameras as t_cameras
from openimucameracalibrator_torch.ops import intervals as t_iv
from openimucameracalibrator_torch.ops import sew as t_sew
from openimucameracalibrator_torch.utils import synthetic as t_synthetic
from openimucameracalibrator_torch.utils import types as t_types
from openimucameracalibrator_tpu.apps import estimate_imu_to_camera_rotation as j_rot_cli
from openimucameracalibrator_tpu.apps import misc_tools as j_misc
from openimucameracalibrator_tpu.core import imu_cam_rotation as j_rot
from openimucameracalibrator_tpu.core import telemetry as j_tel
from openimucameracalibrator_tpu.ops import intervals as j_iv
from openimucameracalibrator_tpu.ops import sew as j_sew
from openimucameracalibrator_tpu.utils import types as j_types

CAM = [437.0, 437.5, 481.0, 271.5]
RATE = 200.0


def _static_then_moving(rng, static_s=3.0, moving_s=12.0):
    """A recording that rests for ``static_s`` (gravity along +y, biases,
    white noise), then moves (sinusoids)."""
    t = np.arange(0.0, static_s + moving_s, 1.0 / RATE)
    moving = t >= static_s
    ba, bg = np.array([0.05, -0.03, 0.08]), np.array([0.004, -0.002, 0.003])
    accel = np.tile([0.0, 9.81, 0.0], (len(t), 1)) + ba + 0.02 * rng.normal(size=(len(t), 3))
    gyro = bg + 0.002 * rng.normal(size=(len(t), 3))
    f = np.array([0.7, 1.3, 2.1])
    accel[moving] += 2.0 * np.sin(2 * np.pi * f * t[moving, None])
    gyro[moving] += 1.5 * np.sin(2 * np.pi * f[::-1] * t[moving, None] + 0.3)
    return t, accel, gyro


@pytest.fixture(scope="module")
def recordings():
    """{name: (times, accel, gyro)}: a static-then-moving record, and a
    dynamic one (the imu-cam scene's, no static span)."""
    rng = np.random.default_rng(11)
    sc = _scene()
    return {"static": _static_then_moving(rng), "dynamic": (sc.imu_times, sc.accel, sc.gyro)}


_SCENE = {}


def _scene():
    """A 10 s imu-cam scene at 10 fps, 100 Hz IMU (pinhole; made once)."""
    if not _SCENE:
        _SCENE["s"] = t_synthetic.make_imu_camera_scene(
            t_cameras.get_model("pinhole"), CAM, duration=10.0, cam_fps=10.0, imu_rate=100.0,
            time_offset=-0.0813, noise_px=0.15, seed=4, device="cpu")
    return _SCENE["s"]


def test_intervals_match_jax(recordings):
    t, accel, gyro = recordings["static"]
    for hw in (5, 50):
        np.testing.assert_array_equal(t_iv.rolling_variance_norm(accel, hw),
                                      j_iv.rolling_variance_norm(accel, hw))
    ivs_t, var_t = t_iv.static_intervals(gyro, 5e-4, half_window=50, min_length=101)
    ivs_j, var_j = j_iv.static_intervals(gyro, 5e-4, half_window=50, min_length=101)
    assert [(iv.start, iv.end) for iv in ivs_t] == [(iv.start, iv.end) for iv in ivs_j]
    assert len(ivs_t) == 1 and ivs_t[0].length > 2.0 * RATE
    np.testing.assert_array_equal(var_t, var_j)
    np.testing.assert_array_equal(t_iv.interval_means(accel, ivs_t, trim=3),
                                  j_iv.interval_means(accel, ivs_j, trim=3))


@pytest.mark.parametrize("name", ["static", "dynamic"])
def test_sew_and_static_biases_match_jax(recordings, name):
    t, accel, gyro = recordings[name]
    st = t_sew.compute_sew(t_types.ImuData(t, accel, gyro), 30.0)
    sj = j_sew.compute_sew(j_types.ImuData(t, accel, gyro), 30.0)
    for k in ("dt_so3", "dt_r3", "std_so3", "std_r3", "cam_fps"):
        assert getattr(st, k) == pytest.approx(getattr(sj, k), rel=1e-12, abs=0), k
    assert 0.01 <= st.dt_so3 <= 0.2 and 0.01 <= st.dt_r3 <= 0.15
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ba_t, bg_t, src_t = t_sew.estimate_static_biases(t_types.ImuData(t, accel, gyro))
    # A dynamic recording says so: zero biases, with a warning.
    assert bool(caught) == (name == "dynamic")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ba_j, bg_j, src_j = j_sew.estimate_static_biases(j_types.ImuData(t, accel, gyro))
    assert src_t == src_j == ("static_interval" if name == "static" else "none")
    np.testing.assert_allclose(ba_t, ba_j, rtol=1e-12, atol=0)
    np.testing.assert_allclose(bg_t, bg_j, rtol=1e-12, atol=0)
    if name == "static":
        np.testing.assert_allclose(bg_t, [0.004, -0.002, 0.003], atol=1e-3)
        np.testing.assert_allclose(ba_t, [0.05, -0.03, 0.08], atol=5e-3)


# ---------------------------------------------------------------------------
# core/imu_cam_rotation.py and its CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rotation_inputs():
    """(poses dict, imu tuple) of the 10 s scene; poses from the port's
    estimate_poses, handed to both packages."""
    sc = _scene()
    ds = t_types.CornerDataset(sc.frame_times, sc.observations, sc.obs_valid,
                               np.asarray(sc.board.points), sc.image_size, 10.0)
    calib = t_types.CameraCalibration("pinhole", np.asarray(CAM), sc.image_size, 0.0)
    p = t_pe.estimate_poses(ds, calib, device="cpu")
    poses = dict(times=p.times, q_w_c=p.q_w_c, t_w_c=p.t_w_c, valid=p.valid,
                 board_points=p.board_points)
    return poses, (sc.imu_times, sc.accel, sc.gyro)


def test_rotation_init_matches_jax(rotation_inputs):
    poses, imu = rotation_inputs
    it = t_rot.estimate_imu_to_camera_rotation(t_types.PoseDataset(**poses),
                                               t_types.ImuData(*imu), device="cpu")
    ij = j_rot.estimate_imu_to_camera_rotation(j_types.PoseDataset(**poses),
                                               j_types.ImuData(*imu))
    tol_s = t_rot.RotationEstimatorOptions().tol_s
    assert abs(it.time_offset - ij.time_offset) < tol_s
    s = np.sign(np.dot(it.q_gyro_to_cam, ij.q_gyro_to_cam))
    np.testing.assert_allclose(s * it.q_gyro_to_cam, ij.q_gyro_to_cam, rtol=0, atol=1e-6)
    np.testing.assert_allclose(it.gyro_bias, ij.gyro_bias, rtol=0, atol=1e-6)
    np.testing.assert_allclose(it.debug_visual_ang_vel, ij.debug_visual_ang_vel, atol=1e-9)
    np.testing.assert_allclose(it.debug_imu_ang_vel_transformed,
                               ij.debug_imu_ang_vel_transformed, atol=1e-6)


def test_rotation_init_names_an_empty_pose_set(rotation_inputs):
    """Stage 7 after a stage 5 that posed no view: the port raises a
    ValueError that names the empty pose set where the JAX package fails
    with an IndexError."""
    poses, imu = rotation_inputs
    none = dict(poses, valid=np.zeros_like(poses["valid"]))
    with pytest.raises(IndexError):
        j_rot.estimate_imu_to_camera_rotation(j_types.PoseDataset(**none), j_types.ImuData(*imu))
    with pytest.raises(ValueError, match="empty pose set"):
        t_rot.estimate_imu_to_camera_rotation(t_types.PoseDataset(**none),
                                              t_types.ImuData(*imu), device="cpu")


def test_rotation_init_recovers_the_truth(rotation_inputs):
    """The JAX test's bars (test_pose_and_rotation.py), on the port alone,
    with camera times far from zero (a 1,000 s clock: the rebase to the
    first IMU sample keeps the search exact)."""
    poses, (t, accel, gyro) = rotation_inputs
    sc = _scene()
    shifted = dict(poses, times=poses["times"] + 1000.0)
    init = t_rot.estimate_imu_to_camera_rotation(t_types.PoseDataset(**shifted),
                                                 t_types.ImuData(t + 1000.0, accel, gyro),
                                                 device="cpu")
    assert abs(init.time_offset - sc.time_offset) < 0.004
    q_want = np.r_[sc.q_i_c[:1], -sc.q_i_c[1:]]
    assert min(np.linalg.norm(init.q_gyro_to_cam - q_want),
               np.linalg.norm(init.q_gyro_to_cam + q_want)) < 0.01
    np.testing.assert_allclose(init.gyro_bias, [0.004, -0.002, 0.003], atol=2e-3)


def test_rotation_cli_matches_jax(rotation_inputs, tmp_path):
    poses, imu = rotation_inputs
    tel, pose_path = str(tmp_path / "tel.json"), str(tmp_path / "poses.npz")
    t_tel.write_generic_json(t_types.CameraTelemetry(imu=t_types.ImuData(*imu)), tel)
    np.savez(pose_path, **poses)
    argv = ["--telemetry_json", tel, "--input_pose_dataset", pose_path, "--debug_dump"]
    out_t, out_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    t_rot_cli.main(argv + ["--imu_rotation_init_output", out_t, "--device", "cpu"])
    j_rot_cli.run(j_rot_cli.build_parser().parse_args(argv + ["--imu_rotation_init_output",
                                                              out_j]))
    with open(out_t) as f, open(out_j) as g:
        a, b = json.load(f), json.load(g)
    assert a.keys() == b.keys()
    assert abs(a["time_offset_gyro_to_cam"] - b["time_offset_gyro_to_cam"]) < 1e-4
    for k in ("gyro_to_camera_rotation", "gyro_bias"):
        np.testing.assert_allclose(list(a[k].values()), list(b[k].values()), atol=1e-6)
    np.testing.assert_allclose(a["debug_visual_ang_vel"], b["debug_visual_ang_vel"], atol=1e-9)
    back = t_rot_cli.load_imu_camera_init(out_t)
    assert back.time_offset == a["time_offset_gyro_to_cam"]


# ---------------------------------------------------------------------------
# core/telemetry.py and apps/misc_tools.py
# ---------------------------------------------------------------------------

def _write_inputs(fmt, d, rng):
    """Write one telemetry file of ``fmt`` into directory ``d``; returns
    (reader name, reader args)."""
    n = 400
    t_ms = np.arange(n) * 5.0 + 12.5
    acc = rng.normal(size=(n, 3)) + [0.0, 9.81, 0.0]
    gyr = 0.3 * rng.normal(size=(n, 3))
    cori = rng.normal(size=(60, 4))
    cori /= np.linalg.norm(cori, axis=1, keepdims=True)
    f_ms = np.arange(60) * 33.3 + 10.0
    gps = np.c_[48.1 + 1e-5 * np.arange(20), 11.5 + 1e-5 * np.arange(20),
                520.0 + np.arange(20), np.ones(20), 1.5 * np.ones(20)]
    g_ms = np.arange(20) * 100.0
    path = os.path.join(d, fmt)
    if fmt == "gopro":
        def samples(ts, vals, **extra):
            return [dict(cts=float(a), value=list(map(float, v)), **extra)
                    for a, v in zip(ts, vals)]
        data = {"1": {"streams": {
            "ACCL": {"samples": samples(t_ms, acc)}, "GYRO": {"samples": samples(t_ms, gyr)},
            "CORI": {"samples": samples(f_ms, cori)},
            "GPS5": {"samples": samples(g_ms, gps, precision=1.5)}}}}
        with open(path, "w") as f:
            json.dump(data, f)
        return "read_gopro_telemetry", (path,)
    if fmt == "pygpmf":
        data = {"ACCL": {"data": acc.tolist(), "timestamps_s": (t_ms / 1e3).tolist()},
                "GYRO": {"data": gyr.tolist()}, "img_timestamps_s": (f_ms / 1e3).tolist(),
                "CORI": {"data": cori.tolist()},
                "GPS5": {"data": gps.tolist(), "timestamps_s": (g_ms / 1e3).tolist()}}
        with open(path, "w") as f:
            json.dump(data, f)
        return "read_pygpmf_json", (path,)
    if fmt == "pilotguru":
        # accelerometer at twice the gyro rate: subsampled by 2
        names = [os.path.join(d, f"{k}.json") for k in ("accelerations", "rotations", "frames")]
        acc_t = 1e6 + 2500.0 * np.arange(n)
        gyr_t = 1e6 + 5000.0 * np.arange(n // 2)
        with open(names[0], "w") as f:
            json.dump({"accelerations": [dict(time_usec=float(a), x=v[0], y=v[1], z=v[2])
                                         for a, v in zip(acc_t, acc.tolist())]}, f)
        with open(names[1], "w") as f:
            json.dump({"rotations": [dict(time_usec=float(a), x=v[0], y=v[1], z=v[2])
                                     for a, v in zip(gyr_t, gyr.tolist())]}, f)
        with open(names[2], "w") as f:
            json.dump({"frames": [dict(time_usec=float(1e6 + 1e3 * a)) for a in f_ms]}, f)
        return "read_pilotguru", tuple(names)
    if fmt == "csv":
        with open(path, "w") as f:
            for a, g, v in zip(t_ms * 1e6, gyr, acc):
                f.write(",".join(map(str, [int(a), *g, *v])) + "\n")
        return "read_generic_csv", (path,)
    if fmt == "zed":
        with open(path, "w") as f:
            f.write(json.dumps({"frames": 0, "time": 0.0}) + "\n")
            for a, g, v in zip(t_ms / 1e3, gyr.tolist(), acc.tolist()):
                f.write(json.dumps({"sensor": {"type": "gyroscope", "values": g},
                                    "time": float(a)}) + "\n\n")
                f.write(json.dumps({"sensor": {"type": "accelerometer", "values": v},
                                    "time": float(a)}) + "\n")
            f.write(json.dumps({"frames": 1, "time": 1.9}) + "\n")
        return "read_zed_jsonl", (path,)
    assert fmt == "generic"
    tel = t_types.CameraTelemetry(
        imu=t_types.ImuData(t_ms / 1e3, acc, gyr), img_times=f_ms / 1e3,
        gps=t_types.GPSData(g_ms / 1e3, gps[:, :3], precision=np.ones(20), vel3d=gps[:, 4]))
    t_tel.write_generic_json(tel, path)
    return "read_generic_json", (path,)


def _assert_same_telemetry(a, b):
    for k in ("times", "accel", "gyro"):
        np.testing.assert_array_equal(getattr(a.imu, k), getattr(b.imu, k))
    for k in ("img_times", "cam_quats"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert (a.gps is None) == (b.gps is None)
    if a.gps is not None:
        for k in ("times", "llh", "precision", "vel3d"):
            x, y = getattr(a.gps, k), getattr(b.gps, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt", ["gopro", "pygpmf", "pilotguru", "csv", "zed", "generic"])
@pytest.mark.parametrize("skip", [0.0, 0.25])
def test_telemetry_importers_match_jax(tmp_path, fmt, skip):
    reader, args = _write_inputs(fmt, str(tmp_path), np.random.default_rng(5))
    a = getattr(t_tel, reader)(*args, skip_seconds=skip)
    b = getattr(j_tel, reader)(*args, skip_seconds=skip)
    _assert_same_telemetry(a, b)
    assert len(a.imu.times) > 50 and np.all(np.diff(a.imu.times) > 0)


def test_telemetry_writers_and_gps_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    _, (path,) = _write_inputs("gopro", str(tmp_path), rng)
    tel_t, tel_j = t_tel.read_gopro_telemetry(path), j_tel.read_gopro_telemetry(path)
    for mod, tel, name in ((t_tel, tel_t, "t"), (j_tel, tel_j, "j")):
        mod.write_kalibr_csv(tel, str(tmp_path / f"{name}.csv"))
        mod.write_generic_json(tel, str(tmp_path / f"{name}.json"))
    for ext in (".csv", ".json"):
        with open(tmp_path / f"t{ext}") as f, open(tmp_path / f"j{ext}") as g:
            assert f.read() == g.read()
    llh = tel_t.gps.llh
    np.testing.assert_array_equal(t_tel.geodetic_to_ecef(*llh.T), j_tel.geodetic_to_ecef(*llh.T))
    q = np.linspace(-0.5, 2.5, 31)
    for x, y in zip(t_tel.gps_positions_at_times(tel_t.gps.times, llh, q),
                    j_tel.gps_positions_at_times(tel_j.gps.times, llh, q)):
        np.testing.assert_array_equal(x, y)
    m_t, m_j = t_tel.merge_telemetry([tel_t, tel_t]), j_tel.merge_telemetry([tel_j, tel_j])
    _assert_same_telemetry(m_t, m_j)
    # GoPro MP4s go to the GPMF reader (tests/test_torch_gpmf.py), which
    # fails on a missing file as the JAX package's does.
    for tel_mod in (t_tel, j_tel):
        with pytest.raises(FileNotFoundError):
            tel_mod.read_gopro_mp4(str(tmp_path / "x.MP4"))


@pytest.mark.parametrize("name", ["static", "dynamic"])
def test_misc_tools_sew_and_biases_match_jax(recordings, tmp_path, name):
    t, accel, gyro = recordings[name]
    tel = str(tmp_path / "tel.json")
    t_tel.write_generic_json(t_types.CameraTelemetry(
        imu=t_types.ImuData(t, accel, gyro), img_times=np.arange(0.0, t[-1], 1 / 30.0)), tel)
    for tool, extra in (("sew_main", ["--q_so3", "0.98"]), ("biases_main", ["--remove_sec", "1"])):
        outs = []
        for mod in (t_misc, j_misc):
            out = str(tmp_path / f"{mod.__name__.split('.')[0]}_{tool}.json")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                getattr(mod, tool)(["--input_json_path", tel, "--output_path", out] + extra)
            with open(out) as f:
                outs.append(json.load(f))
        assert outs[0] == outs[1], tool
    # The other tools are ported (tests/test_torch_static_imu.py,
    # test_torch_recorded.py): like the JAX package's, each needs its
    # arguments.
    for tool in ("static_imu_main", "allan_main", "debug_calib_main", "result_stats_main"):
        for mod in (t_misc, j_misc):
            with pytest.raises(SystemExit):
                getattr(mod, tool)([])
    # extract-frames decodes video through cv2 and says so without it
    # (board_main: tests/test_torch_charuco.py)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError, match="cv2"):
            t_misc.extract_frames_main(["--path_to_videofile", str(tmp_path / "v.MP4"),
                                        "--path_to_image_output", str(tmp_path / "frames")])
