"""Gyroscope orientation integration (RK4 on quaternions), differentiable.

Port of ``ops/imu_integration.py`` of the JAX package (the reference's
RK4 integrator, utils/gyro_integration.h:82-203, QuatIntegrationStepRK4 /
IntegrateGyroInterval), used by the multi-pose static IMU calibrator's
gyro residual (static_imu_calibrator.h:56-143). The JAX package scans one
sequence with ``lax.scan`` and vmaps the scan over segments; here one
time loop steps every sequence of a batch at once, on tensors, so
``torch.func`` differentiates it with respect to the gyro corrections.
The quaternion product with the rate is a 4x4 matrix (``omega_matrix``),
so each step launches a handful of small batched products.
"""

from __future__ import annotations

import torch

from openimucameracalibrator_torch.ops import lie


def omega_matrix(w):
    """(..., 4, 4) matrix of dq/dt = 0.5 * q ⊗ [0, w] acting on q (w, x, y, z)."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return 0.5 * torch.stack([torch.stack([z, -wx, -wy, -wz], -1),
                              torch.stack([wx, z, wz, -wy], -1),
                              torch.stack([wy, -wz, z, wx], -1),
                              torch.stack([wz, wy, -wx, z], -1)], -2)


def _mv(m, q):
    return (m @ q[..., None])[..., 0]


def _rk4(q, m0, mm, m1, dt):
    """RK4 step given the rate matrices at t, t + dt/2 and t + dt."""
    dt = dt[..., None]
    k1 = _mv(m0, q)
    k2 = _mv(mm, q + 0.5 * dt * k1)
    k3 = _mv(mm, q + 0.5 * dt * k2)
    k4 = _mv(m1, q + dt * k3)
    return lie.quat_normalize(q + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4))


def rk4_step(q, w0, w1, dt):
    """One RK4 step from gyro sample w0 (at t) to w1 (at t+dt)
    (gyro_integration.h:82-108); ``dt`` broadcasts against ``q[..., 0]``.
    Returns the normalized quaternion."""
    return _rk4(q, omega_matrix(w0), omega_matrix(0.5 * (w0 + w1)), omega_matrix(w1), dt)


def integrate_gyro(times: torch.Tensor, gyro: torch.Tensor, q0: torch.Tensor | None = None):
    """Integrate gyro sequences to final orientation quaternions.

    times: (..., N), gyro: (..., N, 3) body rates; every sequence of the
    batch is stepped at once. Returns q (..., 4) mapping each initial body
    frame to its final body frame (IntegrateGyroInterval,
    gyro_integration.h:156-203). The rate matrices of every step are built
    before the loop, so a step is four small matrix-vector products and
    the update (what the loop launches per step, under ``torch.func``
    too). A step with dt = 0 (padding with a repeated timestamp and zero
    rate) leaves q unchanged.
    """
    if q0 is None:
        q0 = lie.quat_identity(gyro.dtype, gyro.device).expand(gyro.shape[:-2] + (4,))
    dts = torch.diff(times, dim=-1)
    m = omega_matrix(gyro)
    mm = omega_matrix(0.5 * (gyro[..., :-1, :] + gyro[..., 1:, :]))
    q = q0
    for k in range(dts.shape[-1]):
        q = _rk4(q, m[..., k, :, :], mm[..., k, :, :], m[..., k + 1, :, :], dts[..., k])
    return q
