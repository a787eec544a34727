"""Facade for continuous-time IMU-camera calibration (stage 8).

Port of ``core/imu_camera_calibrator.py`` of the JAX package: build the
spline problem from corners + poses + telemetry + SEW + the gyro-camera
init, run the two-stage batch optimization (all parameters, then
+line delay / time offset), and report the result artifact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openimucameracalibrator_torch.core import spline_estimator as se
from openimucameracalibrator_torch.solver import lm
from openimucameracalibrator_torch.utils import precision
from openimucameracalibrator_torch.utils.types import (CameraCalibration, CornerDataset,
                                                       ImuCameraInit, ImuData,
                                                       PoseDataset, SplineWeightingData)


@dataclasses.dataclass
class ImuCameraCalibrationResult:
    q_i_c: np.ndarray  # camera-to-IMU rotation (T_w_c = T_w_i * T_i_c)
    t_i_c: np.ndarray
    time_offset: float
    gravity: np.ndarray
    line_delay: float
    mean_reproj_error: float
    final_cost: float
    iterations: int
    params: dict  # full spline parameter dict (tensors)
    problem: se.SplineProblem
    solver_status: str = ""
    cost_history: np.ndarray | None = None
    per_view_rmse: np.ndarray | None = None
    # RS line delay before refinement (1/fps/rows)
    init_line_delay: float | None = None
    # per LM stage: iterations, status, wall seconds, linearizations
    stages: list | None = None


def calibrate_imu_camera(corners: CornerDataset, calib: CameraCalibration,
                         poses: PoseDataset, imu: ImuData,
                         init: ImuCameraInit, sew: SplineWeightingData,
                         *, rolling_shutter: bool = False,
                         image_height: int | None = None,
                         accel_bias0=None, gyro_bias0=None,
                         optimize_gravity: bool = True,
                         refine_time_offset: bool = True,
                         accl_intrinsics=None, gyro_intrinsics=None,
                         optimize_imu_intrinsics: bool = False,
                         optimize_board_points: bool = False,
                         board_point_cov=None, reproj_cov=None,
                         max_iters: int = 50, line_delay_iters: int = 25,
                         checkpoint_dir: str | None = None,
                         dtype=None, device=None) -> ImuCameraCalibrationResult:
    """Full batch calibration (reference stage 8) on ``device`` (default
    ``"cuda"``; raises where no CUDA device is present unless
    ``device="cpu"``).

    ``init.q_gyro_to_cam`` maps IMU-frame vectors into the camera frame
    (omega_cam = R omega_imu), so the extrinsic rotation q_i_c (camera
    frame -> IMU frame as used in T_w_c = T_w_i * T_i_c) is its conjugate.
    """
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    # Only views that survived pose estimation enter the batch problem.
    if poses.valid.shape[0] == corners.valid.shape[0]:
        corners = dataclasses.replace(
            corners, valid=np.asarray(corners.valid) & np.asarray(poses.valid)[:, None])
    problem = se.build_problem(corners, calib, imu, sew, init.time_offset,
                               rolling_shutter, dtype=dtype, device=device)
    if optimize_board_points or reproj_cov is not None:
        problem = se.enable_board_points(problem, point_cov=board_point_cov,
                                         reproj_cov=reproj_cov)
    q = np.asarray(init.q_gyro_to_cam, np.float64)
    q_i_c0 = np.concatenate([q[:1], -q[1:]])  # conjugate
    params0 = se.init_spline_params(poses, q_i_c0, np.zeros(3), problem, imu,
                                    pose_time_offset=init.time_offset,
                                    dtype=dtype, device=device)

    def fill(v, like):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device).expand_as(like).clone()

    if gyro_bias0 is None:
        gyro_bias0 = init.gyro_bias
    params0["bias_g"] = fill(gyro_bias0, params0["bias_g"])
    if accel_bias0 is not None:
        params0["bias_a"] = fill(accel_bias0, params0["bias_a"])
    if rolling_shutter:
        h = image_height or corners.image_size[1]
        fps = sew.cam_fps or 30.0
        params0["line_delay"] = torch.tensor([1.0 / fps / h], dtype=dtype, device=device)
    if accl_intrinsics is not None:
        params0["accl_intr"] = se.accl_intr_from(accl_intrinsics, dtype, device)
    if gyro_intrinsics is not None:
        params0["gyro_intr"] = se.gyro_intr_from(gyro_intrinsics, dtype, device)

    flags = {se.SPLINE, se.T_I_C, se.IMU_BIASES}
    if optimize_gravity:
        flags.add(se.GRAVITY_DIR)
    if optimize_imu_intrinsics:
        flags.add(se.IMU_INTRINSICS)
    if optimize_board_points:
        flags.add(se.POINTS)
    stage2 = set()
    if rolling_shutter:
        stage2.add(se.CAM_LINE_DELAY)
    if refine_time_offset:
        stage2.add(se.TIME_OFFSET)
    schedule = [(frozenset(flags), max_iters)]
    if stage2 and line_delay_iters > 0:
        schedule.append((frozenset(flags | stage2), line_delay_iters))
    # "fused" LM: the trial cost comes from the linearization at the
    # candidate, so an accepted step's linearization is reused.
    results = se.optimize_stages(problem, params0, schedule,
                                 checkpoint_dir=checkpoint_dir, strategy="fused")
    res = results[-1]
    params = res.params
    iters = sum(int(r.iterations) for r in results)
    hist = np.concatenate([r.cost_history.cpu().numpy()[:int(r.iterations)] for r in results])

    err = se.mean_reprojection_error(problem, params)
    per_view = se.per_view_reprojection_rmse(problem, params, corners.num_points)
    return ImuCameraCalibrationResult(
        q_i_c=params["q_i_c"].cpu().numpy().astype(np.float64),
        t_i_c=params["t_i_c"].cpu().numpy().astype(np.float64),
        time_offset=init.time_offset + float(params["time_offset"][0]),
        gravity=params["gravity"].cpu().numpy().astype(np.float64),
        line_delay=float(params["line_delay"][0]),
        mean_reproj_error=err, final_cost=float(res.cost), iterations=iters,
        params=params, problem=problem,
        solver_status=lm.STATUS_NAMES[int(res.status)],
        cost_history=hist, per_view_rmse=per_view,
        init_line_delay=(1.0 / (sew.cam_fps or 30.0)
                         / (image_height or corners.image_size[1])
                         if rolling_shutter else None),
        stages=[{"iterations": int(r.iterations), "status": lm.STATUS_NAMES[int(r.status)],
                 "seconds": float(r.seconds), "linearizations": int(r.linearizations)}
                for r in results])
