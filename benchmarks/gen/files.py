"""The users' file formats, written from a scene: the benchmark's frozen
copy of the port's corner-file writer (``utils/io.save_corners`` with the
UBJSON encoder of ``utils/ubjson.py``: the ``.uson`` schema of the
reference's board_extractor.cc) and of its generic telemetry json writer
(``core/telemetry.write_generic_json``).
"""

from __future__ import annotations

import json
import struct

import numpy as np

_INT_MARKERS = (("i", "b", -(2 ** 7), 2 ** 7 - 1), ("U", "B", 0, 2 ** 8 - 1),
                ("I", ">h", -(2 ** 15), 2 ** 15 - 1), ("l", ">i", -(2 ** 31), 2 ** 31 - 1),
                ("L", ">q", -(2 ** 63), 2 ** 63 - 1))


def _int(n: int, out: bytearray):
    for marker, fmt, lo, hi in _INT_MARKERS:
        if lo <= n <= hi:
            out += marker.encode()
            out += struct.pack(fmt, n)
            return
    raise OverflowError(n)


def _key(s: str, out: bytearray):
    b = s.encode("utf-8")
    _int(len(b), out)
    out += b


def _value(v, out: bytearray):
    """UBJSON (Draft 12) of the few types the corner file holds; counted
    containers, as the port writes them."""
    if isinstance(v, bool):
        out += b"T" if v else b"F"
    elif isinstance(v, int):
        _int(v, out)
    elif isinstance(v, float):
        out += b"D"
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        out += b"S"
        _key(v, out)
    elif isinstance(v, (list, tuple)):
        out += b"[#"
        _int(len(v), out)
        for x in v:
            _value(x, out)
    elif isinstance(v, dict):
        out += b"{#"
        _int(len(v), out)
        for k, x in v.items():
            _key(str(k), out)
            _value(x, out)
    else:
        raise TypeError(f"cannot UBJSON-encode {type(v)}")


def _encoded(v) -> bytes:
    out = bytearray()
    _value(v, out)
    return bytes(out)


def write_corners(path: str, times, points2d, valid, board_points, image_size, fps):
    """The ``.uson`` corner file: the bytes ``_value(corners_dict(...))``
    gives, with each view's points packed from arrays (the generic encoder
    takes seconds for a 60 s recording)."""
    points2d = np.asarray(points2d, np.float64)
    valid = np.asarray(valid, bool)
    key = [_encoded(str(i))[1:] for i in range(points2d.shape[1])]  # length + text
    pair = b"[#" + _encoded(2)
    views = bytearray()
    for v in range(len(times)):
        ids = np.nonzero(valid[v])[0]
        xy = points2d[v, ids].astype(">f8").tobytes()
        body = bytearray(b"{#" + _encoded(len(ids)))
        for j, i in enumerate(ids):
            body += key[i] + pair + b"D" + xy[16 * j:16 * j + 8] + b"D" + xy[16 * j + 8:16 * j + 16]
        _key(str(int(round(times[v] * 1e6))), views)
        views += b"{#" + _encoded(1) + _encoded("image_points")[1:] + body
    head = {"views": None, "scene_pts": {str(i): [float(x) for x in board_points[i]]
                                         for i in range(len(board_points))},
            "image_width": int(image_size[0]), "image_height": int(image_size[1]),
            "camera_fps": float(fps)}
    out = bytearray(b"{#" + _encoded(len(head)))
    for k, x in head.items():
        _key(k, out)
        out += (b"{#" + _encoded(len(times)) + views) if k == "views" else _encoded(x)
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_generic_telemetry(path: str, imu_times, accel, gyro, cam_fps: float):
    """The pipeline's interchange json: IMU samples, no frame stamps."""
    with open(path, "w") as f:
        json.dump({"accelerometer": np.asarray(accel).tolist(),
                   "gyroscope": np.asarray(gyro).tolist(),
                   "timestamps_ns": (np.asarray(imu_times) / 1e-9).tolist(),
                   "img_timestamps_ns": [], "camera_fps": cam_fps}, f)
