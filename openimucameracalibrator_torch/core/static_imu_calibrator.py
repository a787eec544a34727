"""Static multi-pose IMU intrinsic calibration (Tedaldi ICRA'14 / imu_tk).

Port of ``core/static_imu_calibrator.py`` of the JAX package (the
reference's StaticImuCalibrator, static_imu_calibrator.cc:54-337, and the
residual functors of static_imu_calibrator.h:18-143):

* accelerometer: detect static intervals by a variance-threshold sweep
  (threshold = k * init-variance, k = 1..10, CalibrateAcc :54-186), then
  fit misalignment/scale/bias so every static mean has norm g:
  r_i = g - || T K (a_i - b) ||.
* gyroscope: bias from the static samples; misalignment/scale fitted so
  RK4-integrating the calibrated gyro across each dynamic segment maps the
  gravity versor of one static pose onto the next
  (MultiPosGyroResidual, static_imu_calibrator.h:56-143).

The interval sweep runs on the host (numpy, ``ops/intervals.py``); each
fit is an LM solve on ``device`` (``lm.make_dense_linearizer``, Jacobian
by ``torch.func.jacfwd``). The gyro residual integrates every dynamic
segment at once: the segments are padded to one length (dt = 0 steps) and
``ops/imu_integration.integrate_gyro`` steps them together.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openimucameracalibrator_torch.ops import imu_integration, intervals, lie
from openimucameracalibrator_torch.solver import blocks, lm
from openimucameracalibrator_torch.utils import precision
from openimucameracalibrator_torch.utils.types import ImuData, ImuIntrinsics


@dataclasses.dataclass
class StaticImuCalibratorOptions:
    gravity: float = 9.81  # static_imu_calibrator.cc:44-52
    min_intervals: int = 12
    init_static_duration_s: float = 30.0
    min_interval_samples: int = 100
    max_threshold_mult: int = 10


def _rows(*rows):
    return torch.stack([torch.stack(r) for r in rows])


def _accel_matrices(theta):
    """theta (9,) -> (T upper-triangular misalignment, K diag, bias).

    imu_tk accelerometer convention: T has unit diagonal with three upper
    off-diagonal elements (static_imu_calibrator.h:18-54)."""
    one, zero = torch.ones_like(theta[0]), torch.zeros_like(theta[0])
    T = _rows([one, -theta[0], theta[1]],
              [zero, one, -theta[2]],
              [zero, zero, one])
    return T, torch.diag(theta[3:6]), theta[6:9]


def _gyro_matrices(theta):
    """theta (9,) -> (T full misalignment, K diag). Bias is pre-estimated.

    imu_tk gyroscope convention: six off-diagonal misalignment terms
    (static_imu_calibrator.h:56-143)."""
    one = torch.ones_like(theta[0])
    T = _rows([one, -theta[0], theta[1]],
              [theta[2], one, -theta[3]],
              [-theta[4], theta[5], one])
    return T, torch.diag(theta[6:9])


def _host(x):
    return x.detach().cpu().numpy().astype(np.float64)


def _theta_layout():
    return blocks.BlockLayout([blocks.BlockSpec("theta", (9,))])


def calibrate_accelerometer(static_means: np.ndarray, g: float = 9.81, device=None,
                            dtype=None):
    """Fit accel misalignment/scale/bias from static-pose means on
    ``device`` (default ``"cuda"``).

    Returns (ImuIntrinsics, final_cost). static_means: (M, 3), M >= 9.
    """
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    means = torch.as_tensor(np.asarray(static_means, np.float64), dtype=dtype, device=device)
    layout = _theta_layout()

    def residual(params):
        T, K, b = _accel_matrices(params["theta"])
        cal = (means - b) @ (T @ K).T
        return g - torch.linalg.vector_norm(cal, dim=-1)

    lin, cost, retract = lm.make_dense_linearizer(residual, layout)
    theta0 = torch.tensor([0, 0, 0, 1, 1, 1, 0, 0, 0], dtype=dtype, device=device)
    res = lm.lm_optimize(lin, cost, retract, {"theta": theta0},
                         layout.free_mask(dtype=dtype, device=device),
                         lm.LMConfig(max_iters=100, ftol=1e-12))
    T, K, b = _accel_matrices(res.params["theta"])
    intr = ImuIntrinsics(misalignment=_host(T), scale=_host(torch.diagonal(K)), bias=_host(b))
    return intr, float(res.cost)


def calibrate_gyroscope(imu: ImuData, static_ivs, accel_intr: ImuIntrinsics,
                        g: float = 9.81, device=None, dtype=None):
    """Fit gyro misalignment/scale given calibrated accel gravity versors,
    on ``device`` (default ``"cuda"``). Returns (ImuIntrinsics, final_cost)."""
    intr, cost, _ = _calibrate_gyroscope(imu, static_ivs, accel_intr, g, device, dtype)
    return intr, cost


def gyro_problem(imu: ImuData, static_ivs, accel_intr: ImuIntrinsics, g: float = 9.81,
                 device=None, dtype=None):
    """The gyro fit's LM problem on ``device`` (default ``"cuda"``):
    (linearize_fn, cost_fn, retract_fn, params0, free_mask, gyro_bias)."""
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    # Bias: mean gyro over all static samples (CalibrateAccGyro :188-220).
    static_mask = np.zeros(len(imu.times), bool)
    for iv in static_ivs:
        static_mask[iv.start:iv.end + 1] = True
    gyro_bias = imu.gyro[static_mask].mean(axis=0)

    # Gravity versors at each static interval (calibrated accel).
    acc_means = intervals.interval_means(imu.accel, static_ivs, trim=10)
    cal_means = accel_intr.unbias_normalize(acc_means)
    versors = cal_means / np.linalg.norm(cal_means, axis=-1, keepdims=True)

    def T_(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    # Dynamic segments between consecutive static intervals, padded with
    # zero rates and repeated timestamps (dt = 0 -> no-op).
    segs = [(a.end - 10, b.start + 10) for a, b in zip(static_ivs[:-1], static_ivs[1:])]
    max_len = max(e - s + 1 for s, e in segs)
    seg_gyro = np.zeros((len(segs), max_len, 3))
    seg_t = np.zeros((len(segs), max_len))
    for k, (s, e) in enumerate(segs):
        n = e - s + 1
        seg_gyro[k, :n] = imu.gyro[s:e + 1] - gyro_bias
        seg_t[k, :n] = imu.times[s:e + 1]
        seg_t[k, n:] = imu.times[e]
    # Times from each segment's start (the same steps; float32 keeps them
    # to ~1e-5 relative where absolute times would keep ~1e-3).
    seg_gyro, seg_t = T_(seg_gyro), T_(seg_t - seg_t[:, :1])
    v0, v1 = T_(versors[:-1]), T_(versors[1:])
    layout = _theta_layout()

    def residual(params):
        T, K = _gyro_matrices(params["theta"])
        q = imu_integration.integrate_gyro(seg_t, seg_gyro @ (T @ K).T)
        # q maps initial body frame to final: a fixed world vector seen in
        # the final frame is R(q)^T applied to its initial-frame coordinates.
        pred = lie.quat_rotate(lie.quat_conjugate(q), v0)
        return (pred - v1).reshape(-1)

    lin, cost, retract = lm.make_dense_linearizer(residual, layout)
    theta0 = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1, 1], dtype=dtype, device=device)
    return (lin, cost, retract, {"theta": theta0}, layout.free_mask(dtype=dtype, device=device),
            gyro_bias)


def _calibrate_gyroscope(imu, static_ivs, accel_intr, g, device, dtype):
    """:func:`calibrate_gyroscope`, and its ``lm.LMResult``."""
    lin, cost, retract, params0, mask, gyro_bias = gyro_problem(imu, static_ivs, accel_intr, g,
                                                                device, dtype)
    res = lm.lm_optimize(lin, cost, retract, params0, mask,
                         lm.LMConfig(max_iters=60, ftol=1e-12))
    T, K = _gyro_matrices(res.params["theta"])
    intr = ImuIntrinsics(misalignment=_host(T), scale=_host(torch.diagonal(K)),
                         bias=gyro_bias)
    return intr, float(res.cost), res


def calibrate(imu: ImuData, options: StaticImuCalibratorOptions | None = None, device=None,
              dtype=None):
    """Full multi-pose calibration on ``device`` (default ``"cuda"``):
    threshold sweep + accel fit + gyro fit.

    Returns (accel_intrinsics, gyro_intrinsics, info dict): the JAX
    package's ``threshold_mult``, ``num_intervals`` and ``gyro_cost``, the
    chosen static ``intervals``, and the gyro LM's ``gyro_iterations``,
    ``gyro_linearizations`` and ``gyro_seconds``.
    """
    opts = options or StaticImuCalibratorOptions()
    device = precision.resolve_device(device)
    rate = imu.rate_hz
    n_init = int(opts.init_static_duration_s * rate)
    if n_init < 100:
        raise ValueError("need an initial static period for variance estimation")
    init_var = intervals.rolling_variance_norm(imu.accel[:n_init], half_window=int(rate // 2))
    base = float(np.min(init_var[np.isfinite(init_var)])) + 1e-12

    best = None
    for k in range(1, opts.max_threshold_mult + 1):
        thr = k * base * 2.0
        ivs, _ = intervals.static_intervals(imu.accel, thr, half_window=int(rate // 2),
                                            min_length=opts.min_interval_samples)
        if len(ivs) < opts.min_intervals:
            continue
        means = intervals.interval_means(imu.accel, ivs, trim=10)
        intr, cost = calibrate_accelerometer(means, opts.gravity, device, dtype)
        cost_per = cost / len(ivs)
        if best is None or cost_per < best[0]:
            best = (cost_per, k, ivs, intr)
    if best is None:
        raise ValueError(
            f"no threshold multiplier produced >= {opts.min_intervals} static intervals")
    _, k, ivs, acc_intr = best
    gyro_intr, gyro_cost, res = _calibrate_gyroscope(imu, ivs, acc_intr, opts.gravity, device,
                                                     dtype)
    return acc_intr, gyro_intr, {
        "threshold_mult": k, "num_intervals": len(ivs), "gyro_cost": gyro_cost, "intervals": ivs,
        "gyro_iterations": int(res.iterations), "gyro_linearizations": res.linearizations,
        "gyro_seconds": res.seconds}
