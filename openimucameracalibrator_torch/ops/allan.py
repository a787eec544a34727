"""Allan-variance IMU noise characterization.

Port of ``ops/allan.py`` of the JAX package (the reference's
allanvariance module, src/allanvariance/{allan_gyr,allan_acc,fitallan_*}.cc
and src/core/allan_variance_fitter.cc:12-110): Allan deviation per axis at
log-spaced cluster times, plus a 5-parameter {Q, N, B, K, R} noise-model
fit sigma^2(tau) = Q^2/tau^2 + N^2/tau + B^2 + K^2 tau + R^2 tau^2
(fitallan_gyr.cc:141-149), from which white-noise density and bias
instability are extracted.

The deviation is host numpy (one cumulative-sum pass per cluster size),
as in the JAX package; the 5-parameter fit is an LM solve on ``device``
through ``lm.make_dense_linearizer``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openimucameracalibrator_torch.solver import blocks, lm
from openimucameracalibrator_torch.utils import precision


def cluster_sizes(n_samples: int, max_clusters: int = 100) -> np.ndarray:
    """Log-spaced averaging-cluster sizes (mirrors the log-spaced stride
    factors of allan_gyr.cc:137-181)."""
    mmax = n_samples // 3
    ms = np.unique(np.round(np.logspace(0, np.log10(max(mmax, 2)), max_clusters))
                   .astype(np.int64))
    return ms[ms >= 1]


def allan_deviation(signal: np.ndarray, rate_hz: float, max_clusters: int = 100):
    """(taus, adev) per axis. signal: (N, d). adev: (M, d).

    Overlapping Allan variance from cumulative sums:
    avar(m) = mean_k ( (S[k+2m] - 2 S[k+m] + S[k]) / (m*dt) )^2 / (2 m^2 dt^2)
    """
    x = np.asarray(signal, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    dt = 1.0 / rate_hz
    ms = cluster_sizes(n, max_clusters)
    # theta: integrated signal (allan_gyr.cc calcThetas equivalent)
    theta = np.concatenate([np.zeros((1, x.shape[1])), np.cumsum(x, axis=0)]) * dt
    taus, avars = [], []
    for m in ms:
        k = n + 1 - 2 * m
        if k < 2:
            break
        d2 = theta[2 * m:2 * m + k] - 2.0 * theta[m:m + k] + theta[:k]
        tau = m * dt
        avars.append(np.mean(d2 ** 2, axis=0) / (2.0 * tau * tau))
        taus.append(tau)
    return np.asarray(taus), np.sqrt(np.asarray(avars))


def _sigma2_model(params, tau):
    Q, N, B, K, R = (params[i] for i in range(5))
    return Q * Q / (tau * tau) + N * N / tau + B * B + K * K * tau + R * R * tau * tau


def fit_noise_params(taus: np.ndarray, adev: np.ndarray, device=None, dtype=None):
    """Fit {Q, N, B, K, R} to one axis' Allan deviation via log-residual LM
    on ``device`` (default ``"cuda"``; the reference uses Ceres DOGLEG with
    polynomial init, fitallan_gyr.cc:22-105)."""
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    taus_t = T(taus)
    sig2 = T(adev.astype(np.float64) ** 2)
    # Rough init from canonical slopes.
    i1 = int(np.argmin(np.abs(taus - 1.0)))
    N0 = float(adev[i1] * np.sqrt(max(taus[i1], 1e-6)))
    B0 = float(adev.min())
    init = T([1e-6, max(N0, 1e-8), max(B0, 1e-8), 1e-6, 1e-8])

    layout = blocks.BlockLayout([blocks.BlockSpec("p", (5,))])

    def residual(params):
        model = _sigma2_model(params["p"], taus_t)
        return torch.log(torch.clamp(model, min=1e-30)) - torch.log(sig2)

    lin, cost, retract = lm.make_dense_linearizer(residual, layout)
    res = lm.lm_optimize(lin, cost, retract, {"p": init},
                         layout.free_mask(dtype=dtype, device=device),
                         lm.LMConfig(max_iters=200, ftol=1e-12))
    return np.abs(res.params["p"].detach().cpu().numpy().astype(np.float64))


@dataclasses.dataclass
class AllanResult:
    taus: np.ndarray
    adev: np.ndarray  # (M, 3)
    params: np.ndarray  # (3, 5): per-axis {Q, N, B, K, R}

    @property
    def white_noise_density(self) -> np.ndarray:
        """N: noise density per axis (units/s/sqrt(Hz))."""
        return self.params[:, 1]

    @property
    def bias_instability(self) -> np.ndarray:
        """B scaled by the canonical 0.664 flicker-floor factor."""
        return self.params[:, 2] * np.sqrt(2.0 * np.log(2.0) / np.pi)

    @property
    def random_walk(self) -> np.ndarray:
        """K: rate random walk per axis."""
        return self.params[:, 3]


def analyze(signal: np.ndarray, rate_hz: float, device=None, dtype=None) -> AllanResult:
    """Full Allan analysis of a 3-axis signal on ``device`` (default
    ``"cuda"``; AllanVarianceFitter::RunFit, allan_variance_fitter.cc:37-110)."""
    device = precision.resolve_device(device)
    taus, adev = allan_deviation(signal, rate_hz)
    params = np.stack([fit_noise_params(taus, adev[:, k], device, dtype)
                       for k in range(adev.shape[1])])
    return AllanResult(taus=taus, adev=adev, params=params)
