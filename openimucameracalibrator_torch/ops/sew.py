"""Spline Error Weighting (Ovren & Forssen, CVPR 2018).

Automatic knot-spacing and residual-weight selection from the frequency
content of the IMU signals — the reference's auto-tuning subsystem
(reference python/sew.py:36-234, python/get_sew_for_dataset.py:38-56).
Without it the continuous-time optimization is ill-weighted (SURVEY.md §5).

Behavioral parity: cubic B-spline interpolation frequency response
(Mihajlovic 1999), reference spectrum = axis-combined FFT magnitude with DC
removed, quality(dt) = fraction of signal energy kept by the spline
low-pass, searched so the kept fraction equals q; variance of the removed
energy becomes the residual std. Host-side numpy/scipy copy of
``ops/sew.py`` of the JAX package: the spectra (numpy FFT of a few
thousand samples) and the scalar root-find both run on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize

from openimucameracalibrator_torch.utils.types import ImuData, SplineWeightingData


def bspline_interp_response(freqs_hz: np.ndarray, dt: float) -> np.ndarray:
    """Normalized cubic B-spline interpolation frequency response H(f).

    H(w) proportional to 3 sinc^4(w/2pi) / (2 + cos w) evaluated at w*dt
    (sew.py:36-59), normalized to H(0) = 1 (sew.py:62-80).
    """
    w = 2.0 * np.pi * freqs_hz * dt
    x = w / (2.0 * np.pi)
    s = np.sinc(x)  # numpy sinc is sin(pi x)/(pi x)
    return 3.0 * s ** 4 / (2.0 + np.cos(w))


def reference_spectrum(signal: np.ndarray) -> np.ndarray:
    """Axis-combined FFT magnitude spectrum, DC removed (sew.py:174-182).

    signal: (N, d) time-major. Returns (N,) nonnegative spectrum.
    """
    S = np.fft.fft(signal, axis=0)
    S[0] = 0.0
    d = signal.shape[1] if signal.ndim == 2 else 1
    return np.sqrt(1.0 / d) * np.linalg.norm(np.atleast_2d(S.T), axis=0)


def _signal_energy(spectrum: np.ndarray) -> float:
    return float(np.sum(np.abs(spectrum) ** 2) / len(spectrum))


def find_knot_spacing(spectrum: np.ndarray, sample_rate: float, quality: float,
                      min_dt: float, max_dt: float) -> float:
    """Largest dt whose spline low-pass keeps `quality` of the energy
    (sew.py:87-162: endpoint check, halving backtrack, Brent refinement)."""
    n = len(spectrum)
    freqs = np.fft.fftfreq(n, d=1.0 / sample_rate)
    max_remove = _signal_energy(spectrum) * (1.0 - quality)

    def qfun(dt):
        H = bspline_interp_response(freqs, dt)
        removed = _signal_energy((1.0 - H) * spectrum)
        return max_remove / max(removed, 1e-300)

    if qfun(max_dt) >= 1.0:
        return max_dt
    dt = max_dt
    step = max_dt * 0.5
    best_q, best_dt = 0.0, min_dt
    while True:
        dt = max(dt - step, min_dt)
        q = qfun(dt)
        if q > 1.0:
            return float(scipy.optimize.brentq(lambda d: qfun(d) - 1.0, dt, max_dt))
        step *= 0.5
        if q > best_q:
            best_q, best_dt = q, dt
        if dt <= min_dt:
            return float(best_dt)


def spline_fit_variance(spectrum: np.ndarray, sample_rate: float, dt: float) -> float:
    """Variance of the energy the spline cannot represent (sew.py:194-234)."""
    n = len(spectrum)
    freqs = np.fft.fftfreq(n, d=1.0 / sample_rate)
    H = bspline_interp_response(freqs, dt)
    return _signal_energy((1.0 - H) * spectrum) / n


def knot_spacing_and_variance(signal: np.ndarray, times: np.ndarray, quality: float,
                              min_dt: float = 0.01, max_dt: float = 0.2):
    """(dt, var) for one signal — the headline SEW API (sew.py:204-234)."""
    rate = 1.0 / float(np.mean(np.diff(times)))
    spec = reference_spectrum(np.asarray(signal, np.float64))
    dt = find_knot_spacing(spec, rate, quality, min_dt, max_dt)
    return dt, spline_fit_variance(spec, rate, dt)


def compute_sew(imu: ImuData, cam_fps: float, q_so3: float = 0.99,
                q_r3: float = 0.99) -> SplineWeightingData:
    """Full SEW artifact for a recording (get_sew_for_dataset.py:38-56:
    gyro -> dt_so3 in [0.01, 0.2], accel -> dt_r3 in [0.01, 0.15])."""
    dt_so3, var_so3 = knot_spacing_and_variance(imu.gyro, imu.times, q_so3,
                                               min_dt=0.01, max_dt=0.2)
    dt_r3, var_r3 = knot_spacing_and_variance(imu.accel, imu.times, q_r3,
                                              min_dt=0.01, max_dt=0.15)
    return SplineWeightingData(
        dt_so3=dt_so3, dt_r3=dt_r3,
        std_so3=float(np.sqrt(var_so3)), std_r3=float(np.sqrt(var_r3)),
        cam_fps=cam_fps)


def estimate_static_biases(imu: ImuData, gravity_const: float = 9.81,
                           gyro_var_thresh: float = 5e-4,
                           accel_var_thresh: float = 0.05) -> tuple:
    """Static-capture bias estimate (python/get_imu_biases.py:39-62):
    gravity removed along the dominant mean-acceleration axis; means of the
    remainder are the biases. Returns (accel_bias (3,), gyro_bias (3,),
    source) where ``source`` is "static_interval" or "none" — callers must
    surface "none" (zero-bias fallback) to downstream consumers.

    The mean-equals-bias assumption only holds while the device is at
    rest, so the estimate is restricted to the longest detected static
    run (variance-norm detector, ops/intervals.py; the reference script
    runs this tool on a deliberately static segment,
    python/get_imu_biases.py). A recording with no >=0.5 s static span
    returns zero biases with a warning — the batch stage optimizes
    biases from that init anyway (IMU_BIASES flag).
    """
    import warnings

    from openimucameracalibrator_torch.ops import intervals

    rate = imu.rate_hz
    hw = max(int(0.25 * rate), 5)
    min_len = max(int(0.5 * rate), 2 * hw + 1)
    ivs_g, _ = intervals.static_intervals(imu.gyro, gyro_var_thresh,
                                          half_window=hw, min_length=min_len)
    va = intervals.rolling_variance_norm(imu.accel, hw)
    static = [iv for iv in ivs_g
              if np.median(va[iv.start:iv.end + 1]) < accel_var_thresh]
    if not static:
        warnings.warn("estimate_static_biases: no static interval found "
                      "(recording is dynamic); returning zero biases")
        return np.zeros(3), np.zeros(3), "none"
    best = max(static, key=lambda iv: iv.length)
    sel = slice(best.start, best.end + 1)
    mean_accl = np.mean(imu.accel[sel], axis=0)
    k = int(np.argmax(np.abs(mean_accl)))
    grav = np.zeros(3)
    grav[k] = gravity_const * np.sign(mean_accl[k])
    return mean_accl - grav, np.mean(imu.gyro[sel], axis=0), "static_interval"
