"""GoPro MP4 telemetry extraction through the native GPMF reader.

Port of ``core/gpmf.py`` of the JAX package (the reference's
py_gpmf_parser stage, python/run_gopro_calibration.py:198-206, and the
pygpmf import path of telemetry_converter.py:285-344): sensor streams come
straight out of the MP4's 'gpmd' track, with the GoPro axis conventions
applied here (ACCL/GYRO channel order [1, 2, 0] -> x, y, z; CORI
(w, x, z, y) -> (w, x, y, z)).

The reader is host C++ (``csrc/gpmf_reader.cc``, the port's copy of the
JAX package's ``native/gpmf_reader.cc``), built with ``g++`` into the
git-ignored ``csrc/build/`` at first use and loaded with ``ctypes``.
Everything here runs on the host; telemetry is plain numpy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from openimucameracalibrator_torch.utils import native
from openimucameracalibrator_torch.utils.types import CameraTelemetry, GPSData, ImuData

_P = ctypes.c_void_p
_S = ctypes.c_char_p
_DBL = ctypes.POINTER(ctypes.c_double)
_INT = ctypes.POINTER(ctypes.c_int)
SYMBOLS = {
    "gpmf_open": ([_S], _P),
    "gpmf_error": ([_P], _S),
    "gpmf_stream_names": ([_P, _S, ctypes.c_int], ctypes.c_int),
    "gpmf_stream_shape": ([_P, _S, _INT, _INT], ctypes.c_int),
    "gpmf_stream_read": ([_P, _S, _DBL, _DBL], ctypes.c_int),
    "gpmf_num_frames": ([_P], ctypes.c_int),
    "gpmf_frame_times": ([_P, _DBL], ctypes.c_int),
    "gpmf_stream_dropped": ([_P, _S], ctypes.c_longlong),
    "gpmf_close": ([_P], None),
}


def library() -> native.Library:
    """The built and loaded reader (``csrc/gpmf_reader.cc``)."""
    return native.load_host_library("gpmf_reader.cc", SYMBOLS)


class GpmfFile:
    """Parsed MP4: sensor streams by fourcc + video frame times."""

    def __init__(self, path: str):
        self._lib = library().lib
        self._h = self._lib.gpmf_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        err = self._lib.gpmf_error(self._h).decode()
        if err:
            self.close()
            raise ValueError(f"{path}: {err}")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gpmf_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def stream_names(self) -> list[str]:
        buf = ctypes.create_string_buffer(4096)
        n = self._lib.gpmf_stream_names(self._h, buf, 4096)
        if n <= 0:
            return []
        return buf.value.decode().split(",")

    def stream(self, fourcc: str):
        """(times (N,), values (N, C)) of one sensor stream, SCAL applied."""
        n = ctypes.c_int()
        c = ctypes.c_int()
        if self._lib.gpmf_stream_shape(self._h, fourcc.encode(),
                                       ctypes.byref(n), ctypes.byref(c)) != 0:
            raise KeyError(fourcc)
        times = np.zeros(n.value, np.float64)
        vals = np.zeros((n.value, c.value), np.float64)
        self._lib.gpmf_stream_read(self._h, fourcc.encode(), times.ctypes.data_as(_DBL),
                                   vals.ctypes.data_as(_DBL))
        return times, vals

    def stream_dropped(self, fourcc: str) -> int:
        """Samples the camera dropped per TSMP accounting (0 if no TSMP)."""
        return int(self._lib.gpmf_stream_dropped(self._h, fourcc.encode()))

    def frame_times(self) -> np.ndarray:
        n = self._lib.gpmf_num_frames(self._h)
        t = np.zeros(n, np.float64)
        if n:
            self._lib.gpmf_frame_times(self._h, t.ctypes.data_as(_DBL))
        return t


def read_gopro_mp4(path: str, skip_seconds: float = 0.0) -> CameraTelemetry:
    """Extract IMU telemetry (+CORI, GPS, frame times) from a GoPro MP4.

    Axis conventions match the reference's pygpmf import
    (telemetry_converter.py:297-309): accl/gyro channels reordered
    [1, 2, 0], CORI quat (w, x, z, y) -> (w, x, y, z). The gyro is
    resampled onto the accelerometer's times when they differ. The frame
    times are the video track's, or the CORI stream's when it has one
    sample per frame.
    """
    with GpmfFile(path) as f:
        names = set(f.stream_names())
        if "ACCL" not in names or "GYRO" not in names:
            raise ValueError(f"{path}: no ACCL/GYRO GPMF streams (found {names})")
        ta, accl = f.stream("ACCL")
        tg, gyro = f.stream("GYRO")
        accl = accl[:, [1, 2, 0]]
        gyro = gyro[:, [1, 2, 0]]
        if len(tg) != len(ta) or not np.allclose(tg, ta):
            gyro = np.stack([np.interp(ta, tg, gyro[:, k]) for k in range(3)], -1)
        t = ta
        quats = None
        img_t = f.frame_times()
        if "CORI" in names:
            tc, cori = f.stream("CORI")
            if cori.shape[1] == 4:
                quats = cori[:, [0, 1, 3, 2]]
                if len(tc) == len(img_t) or img_t.size == 0:
                    img_t = tc
        gps = None
        if "GPS5" in names:
            # GPS5 sample: [lat deg, lon deg, alt m, speed2d m/s, speed3d m/s]
            # (reference python/telemetry_converter.py:346-385); GPSP carries
            # the dilution-of-precision track on the same clock.
            tgps, g5 = f.stream("GPS5")
            if g5.shape[1] >= 3 and len(tgps):
                prec = None
                if "GPSP" in names:
                    tp, pv = f.stream("GPSP")
                    if len(tp):
                        prec = np.interp(tgps, tp, pv[:, 0])
                gps = GPSData(times=tgps, llh=g5[:, :3], precision=prec,
                              vel3d=g5[:, 4] if g5.shape[1] >= 5 else None)
        if skip_seconds > 0.0:
            keep = t >= t[0] + skip_seconds
            t, accl, gyro = t[keep], accl[keep], gyro[keep]
        return CameraTelemetry(imu=ImuData(times=t, accel=accl, gyro=gyro),
                               img_times=img_t if img_t.size else None,
                               cam_quats=quats, gps=gps)
