"""Static-interval detection for multi-pose IMU calibration.

Host-side numpy copy of ``ops/intervals.py`` of the JAX package, the
equivalent of the reference's imu_tk-derived utilities
(reference src/utils/imu_data_interval.cc:35-151: DataMean /
DataVariance / StaticIntervalsDetector / ExtractIntervalsSamples).
Vectorized sliding-window variance over the accelerometer norm.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataInterval:
    start: int
    end: int  # inclusive

    @property
    def length(self) -> int:
        return self.end - self.start + 1


def rolling_variance_norm(signal: np.ndarray, half_window: int) -> np.ndarray:
    """||per-axis variance||_2 in a centered window (imu_data_interval.cc:
    111-135). signal: (N, 3); returns (N,) with edges marked +inf."""
    n = signal.shape[0]
    w = 2 * half_window + 1
    out = np.full(n, np.inf)
    if n < w:
        return out
    c1 = np.concatenate([np.zeros((1, 3)), np.cumsum(signal, axis=0)])
    c2 = np.concatenate([np.zeros((1, 3)), np.cumsum(signal ** 2, axis=0)])
    s1 = c1[w:] - c1[:-w]
    s2 = c2[w:] - c2[:-w]
    var = s2 / w - (s1 / w) ** 2
    out[half_window:n - half_window] = np.linalg.norm(np.maximum(var, 0.0), axis=1)
    return out


def static_intervals(signal: np.ndarray, threshold: float,
                     half_window: int = 50, min_length: int = 100):
    """Contiguous runs where the variance norm stays under threshold
    (StaticIntervalsDetector, imu_data_interval.cc:111-151)."""
    var = rolling_variance_norm(signal, half_window)
    mask = var < threshold
    intervals = []
    start = None
    for i, m in enumerate(mask):
        if m and start is None:
            start = i
        elif not m and start is not None:
            if i - start >= min_length:
                intervals.append(DataInterval(start, i - 1))
            start = None
    if start is not None and len(mask) - start >= min_length:
        intervals.append(DataInterval(start, len(mask) - 1))
    return intervals, var


def interval_means(signal: np.ndarray, intervals, trim: int = 0) -> np.ndarray:
    """Per-interval mean samples (ExtractIntervalsSamples,
    imu_data_interval.cc:64-109)."""
    out = []
    for iv in intervals:
        a, b = iv.start + trim, iv.end + 1 - trim
        out.append(signal[a:b].mean(axis=0))
    return np.asarray(out)
