"""Timestamp search and signal resampling (lerp / slerp).

Port of ``ops/interpolation.py`` of the JAX package: batched,
searchsorted-based linear and spherical resampling.
"""

from __future__ import annotations

import torch

from openimucameracalibrator_torch.ops import lie


def _bracket(times: torch.Tensor, query: torch.Tensor):
    """Indices (i0, i1) and fraction a with times[i0] <= q <= times[i1]."""
    i1 = torch.clamp(torch.searchsorted(times, query, right=True), 1, times.shape[0] - 1)
    i0 = i1 - 1
    t0 = times[i0]
    t1 = times[i1]
    a = (query - t0) / torch.clamp(t1 - t0, min=1e-12)
    return i0, i1, torch.clamp(a, 0.0, 1.0)


def interp_vector(times: torch.Tensor, values: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Linear resampling of (N, d) samples at (M,) query times (clamped)."""
    i0, i1, a = _bracket(times, query)
    return values[i0] * (1.0 - a[..., None]) + values[i1] * a[..., None]


def interp_quaternion(times: torch.Tensor, quats: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Slerp resampling of (N, 4) quats at (M,) query times (clamped)."""
    i0, i1, a = _bracket(times, query)
    return lie.quat_slerp(quats[i0], quats[i1], a)


def closest_index(times: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Index of the sample nearest each query time."""
    i0, i1, a = _bracket(times, query)
    return torch.where(a < 0.5, i0, i1)


def moving_average(x: torch.Tensor, window: int) -> torch.Tensor:
    """Centered moving average over axis 0 with edge clamping."""
    pad_lo = window // 2
    pad_hi = window - 1 - pad_lo
    xp = torch.cat([x[:1].repeat_interleave(pad_lo, 0), x,
                    x[-1:].repeat_interleave(pad_hi, 0)])
    c = torch.cumsum(xp, dim=0)
    c = torch.cat([torch.zeros_like(c[:1]), c], dim=0)
    return (c[window:] - c[:-window]) / window
