"""GoPro-style MP4 muxer: MJPEG video track + GPMF ('gpmd') telemetry track.

Port of ``utils/mp4_writer.py`` of the JAX package (host numpy; it writes
the same bytes for the same inputs). Write-side twin of the native reader
(``csrc/gpmf_reader.cc``): produces an ISO-BMFF file whose video track
decodes with any FFmpeg-based reader (cv2.VideoCapture) and whose 'gpmd'
track round-trips through the GPMF parser. The recorded-data harness
(``utils/recorded.make_recording``) renders frames from a known
trajectory and muxes them with the matching IMU telemetry, so the
pipeline runs from the MP4 alone, the entry point of the reference's
GoPro flow (python/run_gopro_calibration.py:137-206).

GoPro conventions honored (telemetry_converter.py:285-344 behavior):
  * ACCL/GYRO payload channel order (z, x, y) — readers remap [1, 2, 0];
  * CORI quaternion payload order (w, x, z, y);
  * one DEVC per payload, STRM per sensor with STNM/SCAL metadata;
  * payload timing from the gpmd track's stts (samples interpolated
    uniformly inside each payload).
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np


# ---------------------------------------------------------------------------
# ISO-BMFF box helpers
# ---------------------------------------------------------------------------

def _box(fourcc: str, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc.encode() + payload


def _full(fourcc: str, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def _mvhd(timescale: int, duration: int) -> bytes:
    m = struct.pack(">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000)
    return _full("mvhd", 0, 0, struct.pack(">IIII", 0, 0, timescale, duration)
                 + struct.pack(">IH2x8x", 0x00010000, 0x0100) + m
                 + b"\0" * 24 + struct.pack(">I", 3))


def _tkhd(track_id: int, duration: int, width: int = 0, height: int = 0) -> bytes:
    m = struct.pack(">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000)
    return _full("tkhd", 0, 7, struct.pack(">IIIII", 0, 0, track_id, 0, duration)
                 + b"\0" * 8 + struct.pack(">HHHH", 0, 0, 0 if width else 0x0100, 0)
                 + m + struct.pack(">II", width << 16, height << 16))


def _mdhd(timescale: int, duration: int) -> bytes:
    return _full("mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, duration,
                                           0x55C4, 0))  # language 'und'


def _hdlr(handler: str, name: str) -> bytes:
    return _full("hdlr", 0, 0, b"\0" * 4 + handler.encode() + b"\0" * 12
                 + name.encode() + b"\0")


def _dinf() -> bytes:
    url = _full("url ", 0, 1, b"")
    return _box("dinf", _full("dref", 0, 0, struct.pack(">I", 1) + url))


def _stts(entries: Sequence[tuple]) -> bytes:
    body = struct.pack(">I", len(entries))
    for count, delta in entries:
        body += struct.pack(">II", count, delta)
    return _full("stts", 0, 0, body)


def _stsc_one_per_chunk() -> bytes:
    return _full("stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))


def _stsz(sizes: Sequence[int]) -> bytes:
    body = struct.pack(">II", 0, len(sizes))
    for s in sizes:
        body += struct.pack(">I", s)
    return _full("stsz", 0, 0, body)


def _stco(offsets: Sequence[int]) -> bytes:
    body = struct.pack(">I", len(offsets))
    for o in offsets:
        body += struct.pack(">I", o)
    return _full("stco", 0, 0, body)


def _visual_sample_entry(fourcc: str, width: int, height: int) -> bytes:
    e = b"\0" * 6 + struct.pack(">H", 1)  # data_reference_index
    e += struct.pack(">HH", 0, 0) + b"\0" * 12
    e += struct.pack(">HH", width, height)
    e += struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
    e += struct.pack(">I", 0) + struct.pack(">H", 1)  # frame_count
    e += b"\x05MJPEG" + b"\0" * 26  # compressorname (pascal, 32 bytes)
    e += struct.pack(">Hh", 24, -1)
    return _box(fourcc, e)


def _plain_sample_entry(fourcc: str) -> bytes:
    return _box(fourcc, b"\0" * 6 + struct.pack(">H", 1))


def _stsd(entry: bytes) -> bytes:
    return _full("stsd", 0, 0, struct.pack(">I", 1) + entry)


def _video_trak(track_id: int, width: int, height: int, timescale: int,
                frame_delta: int, n_frames: int, sizes, offsets) -> bytes:
    duration = frame_delta * n_frames
    stbl = _box("stbl", _stsd(_visual_sample_entry("jpeg", width, height))
                + _stts([(n_frames, frame_delta)]) + _stsc_one_per_chunk()
                + _stsz(sizes) + _stco(offsets))
    vmhd = _full("vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    minf = _box("minf", vmhd + _dinf() + stbl)
    mdia = _box("mdia", _mdhd(timescale, duration) + _hdlr("vide", "VideoHandler")
                + minf)
    return _box("trak", _tkhd(track_id, duration, width, height) + mdia)


def _gpmd_trak(track_id: int, timescale: int, payload_delta: int,
               n_payloads: int, sizes, offsets) -> bytes:
    duration = payload_delta * n_payloads
    stbl = _box("stbl", _stsd(_plain_sample_entry("gpmd"))
                + _stts([(n_payloads, payload_delta)]) + _stsc_one_per_chunk()
                + _stsz(sizes) + _stco(offsets))
    gmhd = _box("gmhd", _full("gmin", 0, 0, struct.pack(">HHHHHH", 0x40, 0x8000,
                                                        0x8000, 0x8000, 0, 0)))
    minf = _box("minf", gmhd + _dinf() + stbl)
    mdia = _box("mdia", _mdhd(timescale, duration)
                + _hdlr("meta", "GoPro MET") + minf)
    return _box("trak", _tkhd(track_id, duration) + mdia)


# ---------------------------------------------------------------------------
# GPMF KLV encoding
# ---------------------------------------------------------------------------

def _klv(key: str, type_char: str, ssize: int, repeat: int, data: bytes) -> bytes:
    pad = (-len(data)) % 4
    return (key.encode() + type_char.encode() + struct.pack(">BH", ssize, repeat)
            + data + b"\0" * pad)


def _klv_nest(key: str, children: bytes) -> bytes:
    # nested containers use type 0; repeat counts 4-byte units
    assert len(children) % 4 == 0
    return (key.encode() + b"\0" + struct.pack(">BH", 1, len(children))
            + children)


def _stream(fourcc: str, name: str, values: np.ndarray,
            scale: float = 1.0) -> bytes:
    """One STRM: STNM + SCAL + float32 sensor leaf (N, C)."""
    vals = np.asarray(values, np.float64)
    n, c = vals.shape
    body = _klv("STNM", "c", 1, len(name), name.encode())
    body += _klv("SCAL", "l", 4, 1, struct.pack(">i", int(scale)))
    data = (vals * scale).astype(">f4").tobytes()
    body += _klv(fourcc, "f", 4 * c, n, data)
    return _klv_nest("STRM", body)


def gpmf_payload(streams: Sequence[tuple]) -> bytes:
    """One 'gpmd' sample: DEVC containing STRM per (fourcc, name, (N,C) array)."""
    body = _klv("DVID", "L", 4, 1, struct.pack(">I", 1))
    body += _klv("DVNM", "c", 1, 6, b"Camera")
    for fourcc, name, values in streams:
        body += _stream(fourcc, name, values)
    return _klv_nest("DEVC", body)


# ---------------------------------------------------------------------------
# Muxer
# ---------------------------------------------------------------------------

def encode_jpeg(gray: np.ndarray, quality: int = 92) -> bytes:
    """Encode a grayscale uint8 frame as JPEG (cv2 if present, else PIL;
    without either it raises naming both)."""
    img = np.asarray(gray, np.uint8)
    try:
        import cv2
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if ok:
            return bytes(buf.tobytes())
    except ImportError:
        pass
    import io

    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("encode_jpeg needs cv2 or PIL (Pillow) to write JPEG frames; "
                          "neither is installed") from e
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", quality=quality)
    return bio.getvalue()


def write_mp4(path: str, jpeg_frames: Sequence[bytes], width: int, height: int,
              fps: float, telemetry_payloads: Sequence[bytes] = (),
              payload_duration_s: float = 1.0) -> None:
    """Write an MP4 with an MJPEG video track and (optionally) a GPMF track.

    jpeg_frames: encoded JPEG bytes, one per frame, uniform ``fps``;
    telemetry_payloads: 'gpmd' samples (see :func:`gpmf_payload`), each
    covering ``payload_duration_s`` of sensor data, starting at t = 0 on
    the shared container clock.
    """
    timescale = 60000
    frame_delta = int(round(timescale / fps))
    ftyp = _box("ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")

    samples = list(jpeg_frames) + list(telemetry_payloads)
    mdat_payload = b"".join(samples)
    mdat = _box("mdat", mdat_payload)
    base = len(ftyp) + 8  # offset of first sample in file

    offsets = []
    off = base
    for s in samples:
        offsets.append(off)
        off += len(s)
    n_v = len(jpeg_frames)
    v_sizes = [len(s) for s in jpeg_frames]
    v_offsets = offsets[:n_v]
    g_sizes = [len(s) for s in telemetry_payloads]
    g_offsets = offsets[n_v:]

    traks = _video_trak(1, width, height, timescale, frame_delta, n_v,
                        v_sizes, v_offsets)
    duration = frame_delta * n_v
    if telemetry_payloads:
        payload_delta = int(round(timescale * payload_duration_s))
        traks += _gpmd_trak(2, timescale, payload_delta,
                            len(telemetry_payloads), g_sizes, g_offsets)
        duration = max(duration, payload_delta * len(telemetry_payloads))
    moov = _box("moov", _mvhd(timescale, duration) + traks)

    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(mdat)
        f.write(moov)


def make_imu_payloads(times: np.ndarray, accel: np.ndarray, gyro: np.ndarray,
                      cam_quats: np.ndarray | None = None,
                      cam_quat_times: np.ndarray | None = None,
                      payload_duration_s: float = 1.0):
    """Chunk IMU streams into per-second GPMF payloads with GoPro channel
    conventions (ACCL/GYRO stored (z, x, y); CORI stored (w, x, z, y)).

    ``times`` must be uniform from 0; samples are grouped by payload index
    so the reader's uniform-in-payload interpolation reproduces them
    exactly. Returns (payloads, payload_duration_s).
    """
    t = np.asarray(times, np.float64)
    n_payloads = int(np.ceil((t[-1] + 1e-9) / payload_duration_s)) if len(t) else 0
    accl_gp = np.asarray(accel, np.float64)[:, [2, 0, 1]]  # (z, x, y)
    gyro_gp = np.asarray(gyro, np.float64)[:, [2, 0, 1]]
    payloads = []
    for k in range(max(n_payloads, 1)):
        lo, hi = k * payload_duration_s, (k + 1) * payload_duration_s
        sel = (t >= lo - 1e-9) & (t < hi - 1e-9)
        streams = [("ACCL", "Accelerometer", accl_gp[sel]),
                   ("GYRO", "Gyroscope", gyro_gp[sel])]
        if cam_quats is not None:
            tc = np.asarray(cam_quat_times if cam_quat_times is not None else t)
            selc = (tc >= lo - 1e-9) & (tc < hi - 1e-9)
            cq = np.asarray(cam_quats, np.float64)[selc][:, [0, 1, 3, 2]]
            streams.append(("CORI", "CameraOrientation", cq))
        payloads.append(gpmf_payload(streams))
    return payloads, payload_duration_s
