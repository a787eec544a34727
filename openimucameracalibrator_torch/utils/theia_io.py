"""Theia ``.calibdata`` pose-dataset interop (cereal PortableBinary).

The reference persists pose datasets as a serialized ``theia::Reconstruction``
(``theia::WriteReconstruction``, used by
reference applications/estimate_camera_poses_from_checkerboard.cc:71 and
read back by continuous_time_imu_to_camera_calibration.cc:96). The on-disk
format is cereal's PortableBinary archive of the pyTheiaSfM
``Reconstruction`` object graph (the reference builds against
urbste/pyTheiaSfM, Dockerfile:4).

This module implements that wire format natively:

* the cereal PortableBinary framing as specified by
  ``cereal/archives/portable_binary.hpp`` — leading little-endian flag
  byte, ``uint64`` container sizes, raw little-endian scalars,
  once-per-type class-version words, and the polymorphic/shared-ptr
  pointer protocol of ``cereal/types/polymorphic.hpp`` (``msb``-tagged
  first-occurrence ids followed by the registered type name and object
  payload);
* the pyTheiaSfM object schema (Reconstruction -> View/Track -> Camera ->
  polymorphic CameraIntrinsicsModel), centralized in the ``_SCHEMA`` notes
  below so a field-order revision lands in one place.

The consuming fields — ``view_name_to_id_``, per-view camera extrinsics
(position + angle-axis orientation), intrinsics parameters, and track
homogeneous points — are exactly what the reference app reads
(continuous_time_imu_to_camera_calibration.cc:110-150). Round-trip
fidelity is covered by tests/test_io.py; byte-level identity against a
binary produced by a live pyTheiaSfM build could not be validated in this
environment (Theia is not installed here), so the reader raises
``TheiaFormatError`` with a byte offset on any framing mismatch instead of
guessing, and the field schema is isolated in one table.
"""

from __future__ import annotations

import io as _io
import struct

import numpy as np

from openimucameracalibrator_torch.utils.types import (CameraCalibration,
                                                     PoseDataset)

_MSB32 = 0x80000000
_INVALID_VIEW_ID = 0xFFFFFFFF


class TheiaFormatError(ValueError):
    pass


# -- host-side quaternion helpers (wxyz Hamilton, matching ops/lie.py) ------

def _quat_to_matrix(q):
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _matrix_to_quat(R):
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def _log_rotation(R):
    """Rotation matrix -> angle-axis vector."""
    q = _matrix_to_quat(R)
    vn = np.linalg.norm(q[1:])
    if vn < 1e-12:
        return np.zeros(3)
    theta = 2.0 * np.arctan2(vn, q[0])
    return q[1:] * (theta / vn)


def _exp_rotation(aa):
    aa = np.asarray(aa, np.float64)
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        K = _skew(aa)
        return np.eye(3) + K
    K = _skew(aa / theta)
    return (np.eye(3) + np.sin(theta) * K
            + (1 - np.cos(theta)) * (K @ K))


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]],
                    np.float64)


# --------------------------------------------------------------------------
# cereal PortableBinary primitives
# --------------------------------------------------------------------------

class _Writer:
    """cereal::PortableBinaryOutputArchive equivalent."""

    def __init__(self):
        self.buf = _io.BytesIO()
        self._versions_written: set = set()   # once per type per archive
        self._poly_ids: dict = {}             # registered name -> id
        self._next_poly = 1                   # 0 is the nullptr id
        self._next_ptr = 1                    # shared-ptr object ids

    def u8(self, v):
        self.buf.write(struct.pack("<B", v))

    def i32(self, v):
        self.buf.write(struct.pack("<i", int(v)))

    def u32(self, v):
        self.buf.write(struct.pack("<I", int(v)))

    def u64(self, v):
        self.buf.write(struct.pack("<Q", int(v)))

    def f64(self, v):
        self.buf.write(struct.pack("<d", float(v)))

    def boolean(self, v):
        self.u8(1 if v else 0)

    def raw(self, b: bytes):
        self.buf.write(b)

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u64(len(b))        # cereal size_type is uint64
        self.raw(b)

    def f64_array(self, a):
        """C-array payload (cereal binary_data: raw doubles, no size)."""
        self.raw(np.ascontiguousarray(a, np.float64).tobytes())

    def f64_vector(self, a):
        a = np.asarray(a, np.float64).ravel()
        self.u64(a.size)
        self.f64_array(a)

    def eigen(self, m, dtype=np.float64):
        """Theia's cereal Eigen saver: int32 rows, int32 cols, raw
        column-major data."""
        m = np.asarray(m)
        if m.ndim == 1:
            m = m[:, None]
        self.i32(m.shape[0])
        self.i32(m.shape[1])
        self.raw(np.asarray(m, dtype).T.tobytes())  # column-major

    def class_version(self, type_name: str, version: int):
        """u32 'cereal_class_version', once per type per archive,
        immediately before the first instance of that type."""
        if type_name not in self._versions_written:
            self._versions_written.add(type_name)
            self.u32(version)

    def poly_ptr_header(self, registered_name: str):
        """Non-null polymorphic shared_ptr prologue: polymorphic id
        (msb-tagged + name string on first occurrence of the type), then
        a fresh msb-tagged shared-ptr object id (payload always follows —
        pointers are never aliased in these files)."""
        if registered_name in self._poly_ids:
            self.u32(self._poly_ids[registered_name])
        else:
            pid = self._next_poly
            self._next_poly += 1
            self._poly_ids[registered_name] = pid
            self.u32(pid | _MSB32)
            self.string(registered_name)
        self.u32(self._next_ptr | _MSB32)
        self._next_ptr += 1

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class _Reader:
    """cereal::PortableBinaryInputArchive equivalent (little-endian)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self._versions_read: set = set()
        self._poly_names: dict = {}

    def _take(self, n) -> bytes:
        if self.pos + n > len(self.data):
            raise TheiaFormatError(
                f"truncated archive: need {n} bytes at offset {self.pos}, "
                f"file has {len(self.data)}")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self):
        return self._take(1)[0]

    def i32(self):
        return struct.unpack("<i", self._take(4))[0]

    def u32(self):
        return struct.unpack("<I", self._take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self._take(8))[0]

    def f64(self):
        return struct.unpack("<d", self._take(8))[0]

    def boolean(self):
        return self.u8() != 0

    def string(self) -> str:
        n = self.u64()
        if n > len(self.data):
            raise TheiaFormatError(
                f"implausible string length {n} at offset {self.pos - 8}")
        return self._take(n).decode("utf-8")

    def f64_array(self, n):
        return np.frombuffer(self._take(8 * n), np.float64).copy()

    def f64_vector(self):
        n = self.u64()
        if n > 1 << 24:
            raise TheiaFormatError(
                f"implausible vector length {n} at offset {self.pos - 8}")
        return self.f64_array(n)

    def eigen(self, dtype=np.float64):
        r, c = self.i32(), self.i32()
        if not (0 <= r <= 1 << 20 and 0 <= c <= 1 << 20):
            raise TheiaFormatError(
                f"implausible Eigen dims {r}x{c} at offset {self.pos - 8}")
        itemsize = np.dtype(dtype).itemsize
        m = np.frombuffer(self._take(itemsize * r * c), dtype).reshape(c, r).T
        return m.copy()

    def class_version(self, type_name: str) -> int:
        if type_name in self._versions_read:
            return 0
        self._versions_read.add(type_name)
        return self.u32()

    def poly_ptr_header(self):
        """Returns the registered type name, or None for a null pointer."""
        pid = self.u32()
        if pid == 0:
            return None
        if pid & _MSB32:
            name = self.string()
            self._poly_names[pid & ~_MSB32] = name
        else:
            if pid not in self._poly_names:
                raise TheiaFormatError(
                    f"unknown polymorphic id {pid} at offset {self.pos - 4}")
            name = self._poly_names[pid]
        ptr_id = self.u32()
        if not ptr_id & _MSB32:
            raise TheiaFormatError(
                "aliased shared_ptr payloads are not supported "
                f"(ptr id {ptr_id} at offset {self.pos - 4})")
        return name


# --------------------------------------------------------------------------
# pyTheiaSfM schema
#
# _SCHEMA (field order per type; pyTheiaSfM sources):
#   Reconstruction (src/theia/sfm/reconstruction.h):
#       next_track_id_ u32, next_view_id_ u32,
#       next_camera_intrinsics_group_id_ u32,
#       view_name_to_id_ umap<string,u32>,
#       view_id_to_camera_intrinsics_group_id_ umap<u32,u32>,
#       views_ umap<u32,View>, tracks_ umap<u32,Track>
#   View (src/theia/sfm/view.h):
#       name_ string, timestamp_ f64, is_estimated_ bool, camera_ Camera,
#       camera_intrinsics_prior_ CameraIntrinsicsPrior,
#       features_ umap<u32,Feature>
#   Feature (src/theia/sfm/feature.h):
#       point_ Vector2d, covariance_ Matrix2d, depth_prior_ f64
#   Camera (src/theia/sfm/camera/camera.h):
#       camera_intrinsics_ shared_ptr<CameraIntrinsicsModel> (polymorphic),
#       image_size_[0] i32, image_size_[1] i32,
#       extrinsics double[6] binary_data (position xyz, then the
#       world-to-camera angle-axis, camera.h ExternalParametersIndex)
#   CameraIntrinsicsModel (…/camera_intrinsics_model.h): parameters_
#       vector<double> (derived models add no fields)
#   Track (src/theia/sfm/track.h):
#       is_estimated_ bool, point_ Vector4d, color_ Matrix<u8,3,1>,
#       view_ids_ uset<u32>, reference_view_id_ u32, inverse_depth_ f64
#   CameraIntrinsicsPrior (…/camera_intrinsics_prior.h):
#       camera_intrinsics_model_type string, image_width i32,
#       image_height i32, then Prior<N> {is_set bool, value double[N]}
#       for the _PRIOR_FIELDS below.
# --------------------------------------------------------------------------

_MODEL_TO_THEIA = {
    "pinhole": "theia::PinholeCameraModel",
    "division_undistortion": "theia::DivisionUndistortionCameraModel",
    "pinhole_radtan": "theia::PinholeRadialTangentialCameraModel",
    "fisheye": "theia::FisheyeCameraModel",
    "fov": "theia::FOVCameraModel",
    "double_sphere": "theia::DoubleSphereCameraModel",
    "extended_unified": "theia::ExtendedUnifiedCameraModel",
}
_THEIA_TO_MODEL = {v: k for k, v in _MODEL_TO_THEIA.items()}
_PRIOR_TYPE = {
    "pinhole": "PINHOLE",
    "division_undistortion": "DIVISION_UNDISTORTION",
    "pinhole_radtan": "PINHOLE_RADIAL_TANGENTIAL",
    "fisheye": "FISHEYE",
    "fov": "FOV",
    "double_sphere": "DOUBLE_SPHERE",
    "extended_unified": "EXTENDED_UNIFIED",
}

_PRIOR_FIELDS = (("focal_length", 1), ("principal_point", 2),
                 ("aspect_ratio", 1), ("skew", 1), ("radial_distortion", 4),
                 ("tangential_distortion", 2), ("position", 3),
                 ("orientation", 3), ("latitude", 1), ("longitude", 1),
                 ("altitude", 1))

_CLASS_VERSIONS = {
    "theia::Reconstruction": 0,
    "theia::View": 0,
    "theia::Camera": 0,
    "theia::Track": 0,
    "theia::CameraIntrinsicsPrior": 0,
    "theia::CameraIntrinsicsModel": 1,
}


def _theia_params(calib: CameraCalibration) -> np.ndarray:
    """Map our canonical intrinsics vectors (models/cameras.py
    CAMERA_MODELS param tuples) to Theia's parameter ordering
    [focal, aspect_ratio, (skew,) px, py, ...distortion] with
    aspect_ratio = fy / fx (each model's CameraIntrinsicsModel
    parameter indices)."""
    p = np.asarray(calib.params, np.float64)
    name = calib.model_name
    if name == "division_undistortion":     # ours: [f, cx, cy, d]
        return np.array([p[0], 1.0, p[1], p[2], p[3]])
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    aspect = fy / fx
    if name == "pinhole":                   # theia: f a s px py k1 k2
        return np.array([fx, aspect, 0.0, cx, cy, 0.0, 0.0])
    if name == "pinhole_radtan":            # theia: f a s px py k1-3 t1-2
        return np.array([fx, aspect, 0.0, cx, cy, *p[4:9]])
    if name == "fisheye":                   # theia: f a s px py k1-4
        return np.array([fx, aspect, 0.0, cx, cy, *p[4:8]])
    if name == "fov":                       # theia: f a px py omega
        return np.array([fx, aspect, cx, cy, p[4]])
    if name in ("double_sphere", "extended_unified"):
        return np.array([fx, aspect, cx, cy, p[4], p[5]])
    raise ValueError(f"no Theia mapping for camera model {name!r}")


def _params_from_theia(name: str, tp, image_size) -> CameraCalibration:
    if name == "division_undistortion":
        params = [tp[0], tp[2], tp[3], tp[4]]
    else:
        fx = tp[0]
        fy = tp[0] * tp[1]
        if name == "fov":
            params = [fx, fy, tp[2], tp[3], tp[4]]
        elif name in ("double_sphere", "extended_unified"):
            params = [fx, fy, tp[2], tp[3], *tp[4:6]]
        elif name == "pinhole":
            params = [fx, fy, tp[3], tp[4]]
        elif name == "pinhole_radtan":
            params = [fx, fy, tp[3], tp[4], *tp[5:10]]
        elif name == "fisheye":
            params = [fx, fy, tp[3], tp[4], *tp[5:9]]
        else:
            raise TheiaFormatError(f"unsupported camera model {name!r}")
    return CameraCalibration(model_name=name,
                             params=np.asarray(params, np.float64),
                             image_size=tuple(int(s) for s in image_size),
                             mean_reproj_error=0.0)


def _write_camera(w: _Writer, calib, q_w_c, t_w_c):
    w.class_version("theia::Camera", _CLASS_VERSIONS["theia::Camera"])
    if calib is None:
        w.u32(0)   # null camera_intrinsics_ shared_ptr
        w.i32(0)
        w.i32(0)
    else:
        w.poly_ptr_header(_MODEL_TO_THEIA[calib.model_name])
        w.class_version("theia::CameraIntrinsicsModel",
                        _CLASS_VERSIONS["theia::CameraIntrinsicsModel"])
        w.f64_vector(_theia_params(calib))
        w.i32(int(calib.image_size[0]))
        w.i32(int(calib.image_size[1]))
    R_w_c = _quat_to_matrix(q_w_c)
    aa = _log_rotation(R_w_c.T)   # Theia stores the cam-from-world rotation
    w.f64_array(np.concatenate([np.asarray(t_w_c, np.float64), aa]))


def _read_camera(r: _Reader):
    r.class_version("theia::Camera")
    name = r.poly_ptr_header()
    calib = None
    if name is not None:
        if name not in _THEIA_TO_MODEL:
            raise TheiaFormatError(f"unknown camera model class {name!r}")
        r.class_version("theia::CameraIntrinsicsModel")
        tp = r.f64_vector()
        size = (r.i32(), r.i32())
        calib = _params_from_theia(_THEIA_TO_MODEL[name], tp, size)
    else:
        r.i32()
        r.i32()
    ext = r.f64_array(6)
    q_w_c = _matrix_to_quat(_exp_rotation(ext[3:6]).T)
    return calib, q_w_c, ext[:3]


def _write_prior(w: _Writer, calib):
    w.class_version("theia::CameraIntrinsicsPrior",
                    _CLASS_VERSIONS["theia::CameraIntrinsicsPrior"])
    if calib is None:
        w.string("PINHOLE")
        w.i32(0)
        w.i32(0)
        vals = {}
    else:
        w.string(_PRIOR_TYPE[calib.model_name])
        w.i32(int(calib.image_size[0]))
        w.i32(int(calib.image_size[1]))
        tp = _theia_params(calib)
        has_skew = calib.model_name in ("pinhole", "pinhole_radtan",
                                        "fisheye")
        pp = tp[3:5] if has_skew else tp[2:4]
        vals = {"focal_length": [tp[0]],
                "principal_point": list(pp),
                "aspect_ratio": [tp[1]]}
    for fname, n in _PRIOR_FIELDS:
        v = vals.get(fname)
        w.boolean(v is not None)
        w.f64_array(np.asarray(v, np.float64) if v is not None
                    else np.zeros(n))


def _read_prior(r: _Reader):
    r.class_version("theia::CameraIntrinsicsPrior")
    model_type = r.string()
    width, height = r.i32(), r.i32()
    priors = {}
    for fname, n in _PRIOR_FIELDS:
        is_set = r.boolean()
        vals = r.f64_array(n)
        if is_set:
            priors[fname] = vals
    return model_type, (width, height), priors


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def save_pose_dataset_calibdata(path: str, poses: PoseDataset,
                                calib: CameraCalibration | None = None,
                                features: dict | None = None):
    """Write a ``.calibdata`` pose dataset.

    View names follow the reference convention ``str(int(t_us))`` — the
    integer microsecond timestamp
    (continuous_time_imu_to_camera_calibration.cc:133 resolves views by
    that name). Tracks ``0..P-1`` carry the (possibly refined) board
    points as homogeneous points. ``features`` optionally maps view
    index -> (ids, corners (K, 2)) to embed the observations."""
    w = _Writer()
    w.boolean(True)   # archive prologue: saved-on-little-endian flag
    w.class_version("theia::Reconstruction",
                    _CLASS_VERSIONS["theia::Reconstruction"])
    valid = np.asarray(poses.valid, bool)
    V = len(poses.times)
    P = len(poses.board_points)
    names = [str(int(round(float(t) * 1e6))) for t in poses.times]
    features = features or {}

    w.u32(P)   # next_track_id_
    w.u32(V)   # next_view_id_
    w.u32(1)   # next_camera_intrinsics_group_id_
    w.u64(V)   # view_name_to_id_
    for i in range(V):
        w.string(names[i])
        w.u32(i)
    w.u64(V)   # view_id_to_camera_intrinsics_group_id_ (one shared group)
    for i in range(V):
        w.u32(i)
        w.u32(0)
    w.u64(V)   # views_
    for i in range(V):
        w.u32(i)
        w.class_version("theia::View", _CLASS_VERSIONS["theia::View"])
        w.string(names[i])
        w.f64(float(poses.times[i]))
        w.boolean(bool(valid[i]))
        _write_camera(w, calib, poses.q_w_c[i], poses.t_w_c[i])
        _write_prior(w, calib)
        ids, corners = features.get(i, (np.zeros(0, np.int64),
                                        np.zeros((0, 2))))
        w.u64(len(ids))
        for k, tid in enumerate(ids):
            w.u32(int(tid))
            w.eigen(np.asarray(corners[k], np.float64))  # point_
            w.eigen(np.eye(2))                           # covariance_
            w.f64(0.0)                                   # depth_prior_
    # observation lists per track, derived from the features
    track_views = {t: [] for t in range(P)}
    for i in range(V):
        ids, _ = features.get(i, (np.zeros(0, np.int64), None))
        for tid in np.asarray(ids, np.int64):
            if 0 <= tid < P:
                track_views[int(tid)].append(i)
    w.u64(P)   # tracks_
    for tid in range(P):
        w.u32(tid)
        w.class_version("theia::Track", _CLASS_VERSIONS["theia::Track"])
        w.boolean(True)
        pt = np.asarray(poses.board_points[tid], np.float64)
        w.eigen(np.concatenate([pt, [1.0]]))             # point_ (4, 1)
        w.eigen(np.zeros((3, 1)), np.uint8)              # color_
        w.u64(len(track_views[tid]))
        for i in track_views[tid]:
            w.u32(i)
        w.u32(_INVALID_VIEW_ID)                          # reference_view_id_
        w.f64(0.0)                                       # inverse_depth_
    with open(path, "wb") as f:
        f.write(w.getvalue())


def load_pose_dataset_calibdata(path: str):
    """Read a ``.calibdata`` file.

    Returns ``(PoseDataset, CameraCalibration | None, features)`` where
    ``features`` maps view index (time order) -> (track ids, corners)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if not r.boolean():
        raise TheiaFormatError("big-endian .calibdata files not supported")
    r.class_version("theia::Reconstruction")
    r.u32()   # next_track_id_
    r.u32()   # next_view_id_
    r.u32()   # next_camera_intrinsics_group_id_
    n = r.u64()
    for _ in range(n):   # view_name_to_id_ (names are re-derived from times)
        r.string()
        r.u32()
    n = r.u64()
    for _ in range(n):   # view_id_to_camera_intrinsics_group_id_
        r.u32()
        r.u32()
    n_views = r.u64()
    views = {}
    calib = None
    for _ in range(n_views):
        vid = r.u32()
        r.class_version("theia::View")
        name = r.string()
        ts = r.f64()
        est = r.boolean()
        c, q_w_c, t_w_c = _read_camera(r)
        calib = calib or c
        _read_prior(r)
        n_feat = r.u64()
        ids = np.zeros(n_feat, np.int64)
        corners = np.zeros((n_feat, 2))
        for k in range(n_feat):
            ids[k] = r.u32()
            corners[k] = r.eigen().ravel()[:2]
            r.eigen()   # covariance_
            r.f64()     # depth_prior_
        views[vid] = (name, ts, est, q_w_c, t_w_c, ids, corners)
    n_tracks = r.u64()
    pts = {}
    for _ in range(n_tracks):
        tid = r.u32()
        r.class_version("theia::Track")
        r.boolean()
        hp = r.eigen().ravel()
        r.eigen(np.uint8)   # color_
        m = r.u64()
        for _ in range(m):
            r.u32()
        r.u32()   # reference_view_id_
        r.f64()   # inverse_depth_
        wgt = hp[3] if abs(hp[3]) > 1e-12 else 1.0
        pts[int(tid)] = hp[:3] / wgt
    order = sorted(views, key=lambda v: views[v][1])
    times = np.array([views[v][1] for v in order])
    q = (np.stack([views[v][3] for v in order]) if order
         else np.zeros((0, 4)))
    t = (np.stack([views[v][4] for v in order]) if order
         else np.zeros((0, 3)))
    valid = np.array([views[v][2] for v in order], bool)
    P = max(pts) + 1 if pts else 0
    board = np.zeros((P, 3))
    for tid, p in pts.items():
        board[tid] = p
    feats = {i: (views[v][5], views[v][6]) for i, v in enumerate(order)}
    poses = PoseDataset(times=times, q_w_c=q, t_w_c=t, valid=valid,
                        board_points=board)
    return poses, calib, feats
