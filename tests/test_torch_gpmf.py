"""The port's GPMF reader and MP4 muxer against the JAX package's.

* ``csrc/gpmf_reader.cc`` is the JAX package's ``native/gpmf_reader.cc``;
  the port builds its own copy with g++ into its git-ignored
  ``csrc/build/``, never into the JAX package's ``native/build/``.
* Both readers parse the same MP4s (the layouts of ``tests/test_gpmf.py``:
  int16 streams with SCAL, GPS5/GPSP, GoPro9-style STMP/TSMP/vector SCAL,
  TICK timing, a stream that loses its clock, and the muxer's own
  ACCL/GYRO/CORI payloads). Tolerance: none -- every array is equal.
* ``utils/mp4_writer`` writes the same bytes as the JAX package's for the
  same inputs. Tolerance: none.

Host code only: no device is involved.
"""

import os
import struct

import numpy as np
import pytest

from openimucameracalibrator_tpu.core import gpmf as j_gpmf
from openimucameracalibrator_tpu.utils import mp4_writer as j_mp4
from openimucameracalibrator_torch.core import gpmf as t_gpmf
from openimucameracalibrator_torch.core import telemetry as t_telemetry
from openimucameracalibrator_torch.utils import mp4_writer as t_mp4
from openimucameracalibrator_torch.utils import native as t_native
from test_gpmf import box, klv, klv_nested, make_track, payload, sensor_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nest(key, children):
    return klv_nested(key, b"".join(children))


def _sample_mp4(rng):
    """tests/test_gpmf.py's layout: int16 ACCL/GYRO with SCAL, 3 payloads,
    a stub 60 fps video track."""
    n_payloads, hz, fps = 3, 200, 60
    accl = rng.normal(0, 2, (n_payloads, hz, 3)) + [0, 0, 9.81]
    gyro = rng.normal(0, 0.5, (n_payloads, hz, 3))
    payloads = [payload(sensor_stream(b"ACCL", accl[k], 418)
                        + sensor_stream(b"GYRO", gyro[k], 939)) for k in range(n_payloads)]
    ftyp = box(b"ftyp", b"mp41" + struct.pack(">I", 0) + b"mp41")
    offsets, cur = [], len(ftyp) + 8
    for p in payloads:
        offsets.append(cur)
        cur += len(p)
    mdat = box(b"mdat", b"".join(payloads))
    gp = make_track(b"meta", b"gpmd", 1000, [(n_payloads, 1000)],
                    [len(p) for p in payloads], offsets)
    vid = make_track(b"vide", b"avc1", 60000, [(n_payloads * fps, 1000)],
                     [1] * (n_payloads * fps), [len(ftyp) + 8])
    return ftyp + mdat + box(b"moov", gp + vid)


def _write(path, payloads, n_frames=60, fps=30.0):
    frame = j_mp4.encode_jpeg(np.zeros((16, 16), np.uint8))
    j_mp4.write_mp4(path, [frame] * n_frames, 16, 16, fps, payloads, payload_duration_s=1.0)


def _gps_mp4(path, rng):
    hz, gps_hz, dur = 200, 10, 2
    t = np.arange(hz * dur) / hz
    tg = np.arange(gps_hz * dur) / gps_hz
    accel = np.tile([0.0, 0.0, 9.81], (len(t), 1)) + 0.01 * rng.normal(size=(len(t), 3))
    gyro = 0.01 * rng.normal(size=(len(t), 3))
    llh = np.stack([48.1 + 1e-5 * tg, 11.5 + 2e-5 * tg, 520 + 0.1 * tg], -1)
    gps5 = np.concatenate([llh, np.full((len(tg), 1), 1.5), np.full((len(tg), 1), 1.7)], -1)
    gpsp = np.full((len(tg), 1), 180.0)
    payloads = []
    for k in range(dur):
        sel, selg = (t >= k) & (t < k + 1), (tg >= k) & (tg < k + 1)
        payloads.append(j_mp4.gpmf_payload([
            ("ACCL", "Accelerometer", accel[sel][:, [2, 0, 1]]),
            ("GYRO", "Gyroscope", gyro[sel][:, [2, 0, 1]]),
            ("GPS5", "GPS", gps5[selg]), ("GPSP", "GPS precision", gpsp[selg])]))
    _write(path, payloads)


def _gopro9_mp4(path, rng):
    """STMP-anchored payloads, TSMP dropped-sample accounting, ORIN/ORIO,
    per-channel SCAL; the second payload's STMP drifts past the MP4 clock."""
    n = 100
    raw = rng.integers(-400, 400, size=(2 * n, 3)).astype(np.int16)
    scal = struct.pack(">3l", 418, 209, 100)

    def strm(k, stmp_us, tsmp):
        return _nest(b"STRM", [
            klv(b"STMP", b"J", 8, 1, struct.pack(">Q", stmp_us)),
            klv(b"TSMP", b"L", 4, 1, struct.pack(">L", tsmp)),
            klv(b"STNM", b"c", 1, 13, b"Accelerometer"),
            klv(b"ORIN", b"c", 1, 3, b"ZXY"), klv(b"ORIO", b"c", 1, 3, b"YxZ"),
            klv(b"SCAL", b"l", 4, 3, scal),
            klv(b"ACCL", b"s", 6, n, raw[k * n:(k + 1) * n].astype(">i2").tobytes())])

    def gyro(k):
        return sensor_stream(b"GYRO", raw[k * n:(k + 1) * n] / 100.0, 100)

    payloads = [_nest(b"DEVC", [klv(b"DVID", b"L", 4, 1, struct.pack(">L", 1)), strm(0, 500_000, n),
                                gyro(0)]),
                _nest(b"DEVC", [klv(b"DVID", b"L", 4, 1, struct.pack(">L", 1)),
                                strm(1, 1_520_000, 2 * n + 10), gyro(1)])]
    _write(path, payloads)


def _tick_mp4(path, rng, ticks=(7000, 8200, None, 10200)):
    """TICK (ms) timing; a payload without TICK inside an anchored stream."""
    n = 50

    def strm(key, tick_ms):
        data = rng.integers(-2000, 2000, size=(n, 3)).astype(">i2")
        head = [] if tick_ms is None else [klv(b"TICK", b"L", 4, 1, struct.pack(">L", tick_ms))]
        return _nest(b"STRM", head + [klv(b"SCAL", b"s", 2, 1, struct.pack(">h", 100)),
                                      klv(key, b"s", 6, n, data.tobytes())])

    _write(path, [_nest(b"DEVC", [strm(b"ACCL", t), strm(b"GYRO", t)]) for t in ticks],
           n_frames=120)


def _muxer_mp4(path, rng):
    """The muxer's own payloads: 200 Hz ACCL/GYRO with a CORI stream at
    the IMU rate (gyro resampling is a no-op, CORI is not per frame)."""
    t = np.arange(0.0, 2.5, 1 / 200)
    accel = rng.normal(size=(len(t), 3)) + [0, 0, 9.81]
    gyro = rng.normal(size=(len(t), 3))
    q = rng.normal(size=(len(t), 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    payloads, dur = j_mp4.make_imu_payloads(t, accel, gyro, cam_quats=q, cam_quat_times=t)
    frames = [j_mp4.encode_jpeg(np.full((8, 8), k, np.uint8)) for k in range(25)]
    j_mp4.write_mp4(path, frames, 8, 8, 10.0, payloads, dur)


def _cori_per_frame_mp4(path, rng):
    """CORI with one sample per video frame: the frame times come from it."""
    fps, dur = 30.0, 2
    t = np.arange(200 * dur) / 200
    tc = np.arange(int(fps * dur)) / fps
    q = rng.normal(size=(len(tc), 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    payloads = []
    for k in range(dur):
        sel, selc = (t >= k) & (t < k + 1), (tc >= k) & (tc < k + 1)
        payloads.append(j_mp4.gpmf_payload([
            ("ACCL", "Accelerometer", rng.normal(size=(sel.sum(), 3))),
            ("GYRO", "Gyroscope", rng.normal(size=(sel.sum() // 2, 3))),
            ("CORI", "CameraOrientation", q[selc][:, [0, 1, 3, 2]])]))
    _write(path, payloads, n_frames=len(tc), fps=fps)


CASES = {"int16_scal": None, "gps": _gps_mp4, "gopro9_stmp_tsmp": _gopro9_mp4,
         "tick_clock": _tick_mp4, "muxer_cori": _muxer_mp4,
         "cori_per_frame": _cori_per_frame_mp4}


@pytest.fixture(scope="module")
def mp4s(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpmf_parity")
    out = {}
    for i, (name, make) in enumerate(CASES.items()):
        path = str(d / f"{name}.mp4")
        rng = np.random.default_rng(i)
        if make is None:
            with open(path, "wb") as f:
                f.write(_sample_mp4(rng))
        else:
            make(path, rng)
        out[name] = path
    return out


def test_reader_source_is_the_jax_packages():
    """The port's copy differs from the JAX package's source in one comment
    line only: the reference's source path there carries its checkout's
    directory prefix, which the copy drops."""
    with open(os.path.join(ROOT, "openimucameracalibrator_tpu/native/gpmf_reader.cc"), "rb") as f:
        ref = f.read().split(b"\n")
    with open(os.path.join(ROOT, "openimucameracalibrator_torch/csrc/gpmf_reader.cc"), "rb") as f:
        port = f.read().split(b"\n")
    assert len(port) == len(ref)
    differ = [i for i, (a, b) in enumerate(zip(port, ref)) if a != b]
    assert differ == [4]
    line = ref[4]
    prefix = line[line.index(b"(") + 1:line.index(b"reference python/")]
    assert prefix.startswith(b"/") and port[4] == line.replace(prefix, b"", 1)


def test_library_builds_under_the_ports_csrc_build():
    lib = t_gpmf.library()
    build = os.path.join(ROOT, "openimucameracalibrator_torch", "csrc", "build")
    assert os.path.dirname(lib.path) == build
    assert os.path.basename(lib.path).startswith("libgpmf_reader_")
    assert os.path.exists(lib.path) and t_native.load_host_library(
        "gpmf_reader.cc", t_gpmf.SYMBOLS) is lib


@pytest.mark.parametrize("case", list(CASES))
def test_readers_agree(mp4s, case):
    path = mp4s[case]
    with j_gpmf.GpmfFile(path) as fj, t_gpmf.GpmfFile(path) as ft:
        names = ft.stream_names()
        assert names == fj.stream_names() and {"ACCL", "GYRO"} <= set(names)
        for s in names:
            for got, want in zip(ft.stream(s), fj.stream(s), strict=True):
                np.testing.assert_array_equal(got, want)
            assert ft.stream_dropped(s) == fj.stream_dropped(s)
        np.testing.assert_array_equal(ft.frame_times(), fj.frame_times())
        if case == "gopro9_stmp_tsmp":
            assert ft.stream_dropped("ACCL") == 10
    for skip in (0.0, 0.5):
        got = t_telemetry.read_gopro_mp4(path, skip_seconds=skip)
        want = j_gpmf.read_gopro_mp4(path, skip_seconds=skip)
        for k in ("times", "accel", "gyro"):
            np.testing.assert_array_equal(getattr(got.imu, k), getattr(want.imu, k))
        for k in ("img_times", "cam_quats"):
            a, b = getattr(got, k), getattr(want, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert (got.gps is None) == (want.gps is None)
        if got.gps is not None:
            for k in ("times", "llh", "precision", "vel3d"):
                np.testing.assert_array_equal(getattr(got.gps, k), getattr(want.gps, k))
    if case == "cori_per_frame":
        np.testing.assert_array_equal(got.img_times, t_gpmf.GpmfFile(path).stream("CORI")[0])


def test_reader_errors_match(tmp_path):
    ftyp = box(b"ftyp", b"mp41" + struct.pack(">I", 0) + b"mp41")
    vid = make_track(b"vide", b"avc1", 60000, [(10, 1000)], [1] * 10, [0])
    path = tmp_path / "plain.mp4"
    path.write_bytes(ftyp + box(b"moov", vid))
    for reader in (t_gpmf.read_gopro_mp4, j_gpmf.read_gopro_mp4):
        with pytest.raises(ValueError, match="no ACCL/GYRO"):
            reader(str(path))
        with pytest.raises(FileNotFoundError):
            reader(str(tmp_path / "missing.mp4"))


def test_mp4_writer_writes_the_jax_packages_bytes(tmp_path):
    rng = np.random.default_rng(7)
    t = np.arange(0.0, 3.0, 1 / 200)
    accel, gyro = rng.normal(size=(len(t), 3)), rng.normal(size=(len(t), 3))
    q = rng.normal(size=(len(t), 4))
    pj, dj = j_mp4.make_imu_payloads(t, accel, gyro, cam_quats=q, cam_quat_times=t)
    pt, dt = t_mp4.make_imu_payloads(t, accel, gyro, cam_quats=q, cam_quat_times=t)
    assert dt == dj and pt == pj
    streams = [("ACCL", "Accelerometer", accel[:50]), ("GPS5", "GPS", rng.normal(size=(5, 5)))]
    assert t_mp4.gpmf_payload(streams) == j_mp4.gpmf_payload(streams)
    frames = [rng.integers(0, 256, (24, 40), dtype=np.uint8) for _ in range(4)]
    jpegs = [t_mp4.encode_jpeg(f, quality=80) for f in frames]
    assert jpegs == [j_mp4.encode_jpeg(f, quality=80) for f in frames]
    for pay, fps in ((pt, 30.0), ((), 2.0)):
        t_mp4.write_mp4(str(tmp_path / "t.mp4"), jpegs, 40, 24, fps, pay, dt)
        j_mp4.write_mp4(str(tmp_path / "j.mp4"), jpegs, 40, 24, fps, pay, dj)
        assert (tmp_path / "t.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()
