"""Core artifact dataclasses passed between pipeline stages.

The reference pipeline passes stage artifacts as files on disk (corner
.uson, calib .json, pose .calibdata, telemetry _gen.json — SURVEY.md §1,
run_gopro_calibration.py:137-333). Here each artifact is an explicit,
in-memory dataclass with optional (de)serialization in utils/io.py; static
array shapes (padded + masked) keep everything jit-friendly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CornerDataset:
    """Per-frame board corner observations (replaces the corner .uson files
    written by board_extractor.cc:385-482)."""

    times: np.ndarray  # (V,) seconds, camera clock
    points2d: np.ndarray  # (V, P, 2) pixel coordinates (padded)
    valid: np.ndarray  # (V, P) bool detection mask
    board_points: np.ndarray  # (P, 3) board 3D points, z = 0 plane
    image_size: tuple  # (width, height)
    fps: float = 0.0

    @property
    def num_views(self) -> int:
        return self.times.shape[0]

    @property
    def num_points(self) -> int:
        return self.board_points.shape[0]


@dataclasses.dataclass
class ImuData:
    """Timestamped IMU stream (generic telemetry json equivalent,
    src/io/read_telemetry.cc:29-70)."""

    times: np.ndarray  # (N,) seconds, IMU clock
    accel: np.ndarray  # (N, 3) m/s^2
    gyro: np.ndarray  # (N, 3) rad/s

    @property
    def rate_hz(self) -> float:
        return 1.0 / float(np.median(np.diff(self.times)))


@dataclasses.dataclass
class GPSData:
    """GPS track (GPXData, utils/types.h:67-77)."""

    times: np.ndarray  # (N,) seconds, telemetry clock
    llh: np.ndarray  # (N, 3) latitude deg, longitude deg, altitude m
    precision: np.ndarray | None = None  # GPS5 dilution of precision
    vel3d: np.ndarray | None = None  # (N,) 3D speed m/s


@dataclasses.dataclass
class CameraTelemetry:
    """Full telemetry of one recording (utils/types.h:123-131)."""

    imu: ImuData
    img_times: np.ndarray | None = None  # (V,) seconds
    gps: GPSData | None = None
    cam_quats: np.ndarray | None = None  # e.g. GoPro CORI, (V, 4) wxyz


@dataclasses.dataclass
class SplineWeightingData:
    """Spline-error-weighting output (utils/types.h:112-119): knot spacings
    and residual stds from the SEW frequency analysis."""

    dt_so3: float
    dt_r3: float
    std_so3: float
    std_r3: float
    cam_fps: float


@dataclasses.dataclass
class CameraCalibration:
    """Intrinsics result (write_camera_calibration.cc:33-140 equivalent)."""

    model_name: str
    params: np.ndarray  # model parameter vector
    image_size: tuple
    mean_reproj_error: float
    fps: float = 0.0


@dataclasses.dataclass
class PoseDataset:
    """Per-frame camera poses with fixed intrinsics (the Theia .calibdata
    artifact of pose_estimator.cc:92-191)."""

    times: np.ndarray  # (V,)
    q_w_c: np.ndarray  # (V, 4) camera-to-world
    t_w_c: np.ndarray  # (V, 3)
    valid: np.ndarray  # (V,) pose solved & accepted
    board_points: np.ndarray  # (P, 3) possibly refined


@dataclasses.dataclass
class ImuCameraInit:
    """IMU-to-camera initialization (A4 output json equivalent)."""

    q_gyro_to_cam: np.ndarray  # (4,)
    time_offset: float  # seconds; add to camera timestamps
    gyro_bias: np.ndarray  # (3,)
    # Optional alignment diagnostics (debug_calib plotting): smoothed visual
    # angular velocity and the time-shifted, bias-corrected gyro rotated
    # into the camera frame, both on the visual time grid.
    debug_visual_ang_vel: np.ndarray | None = None
    debug_imu_ang_vel_transformed: np.ndarray | None = None


@dataclasses.dataclass
class ImuIntrinsics:
    """Misalignment/scale/bias for one 3-axis sensor
    (utils/types.h:170-328 ThreeAxisSensorCalibParams)."""

    misalignment: np.ndarray  # (3, 3) lower/upper triangular T
    scale: np.ndarray  # (3,) diagonal of K
    bias: np.ndarray  # (3,)

    def unbias_normalize(self, x: np.ndarray) -> np.ndarray:
        TK = self.misalignment @ np.diag(self.scale)
        return (x - self.bias) @ TK.T

    @classmethod
    def identity(cls):
        return cls(np.eye(3), np.ones(3), np.zeros(3))
