"""Uniform B-spline evaluation: Euclidean (R^d) and cumulative SO(3).

Port of ``ops/spline.py`` of the JAX package. Evaluators are plain
functions of a static-size knot window ``(N, ...)`` plus the normalized
position ``u`` in the segment, so they ``torch.func.vmap`` over
measurement batches and differentiate (forward or reverse) w.r.t. the
knots. Time derivatives of the cumulative SO(3) spline are taken with
``torch.func.jvp`` over ``u``, as the JAX package does with ``jax.jvp``.

Conventions: order ``N`` splines have degree ``N-1``; a measurement at time
``t`` with knot spacing ``dt`` and origin ``t0`` lives in segment
``i = floor((t-t0)/dt)`` with local coordinate ``u = (t-t0)/dt - i`` and
touches knots ``i .. i+N-1``. Segment indices are int64 (torch's index
type) where the JAX package uses int32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.func import jvp, vmap

from openimucameracalibrator_torch.ops import lie


@functools.lru_cache(maxsize=None)
def blending_matrix(order: int, cumulative: bool = False) -> np.ndarray:
    """Uniform B-spline blending matrix M (order x order), float64.

    ``b_j(u) = sum_n M[j, n] u^n`` gives the weight of control point
    ``p_{i+j}``. With ``cumulative=True`` returns the cumulative matrix
    ``M~[j] = sum_{s>=j} M[s]`` used by the Lie-group spline.
    """
    n = order
    m = np.zeros((n, n), dtype=np.float64)
    for j in range(n):  # control point index
        for i in range(n):  # power of u
            s_sum = 0.0
            for s in range(j, n):
                s_sum += (-1.0) ** (s - j) * math.comb(n, s - j) * (n - s - 1.0) ** (n - 1 - i)
            m[j, i] = math.comb(n - 1, n - 1 - i) * s_sum
    m /= math.factorial(n - 1)
    if cumulative:
        m = np.flipud(np.cumsum(np.flipud(m), axis=0))
    return m


@functools.lru_cache(maxsize=None)
def _deriv_factors(order: int, deriv: int) -> np.ndarray:
    """Row vector f with (d^deriv/du^deriv) u^n = f[n] * u^(n-deriv)."""
    f = np.zeros(order)
    for nn in range(deriv, order):
        f[nn] = math.factorial(nn) / math.factorial(nn - deriv)
    return f


@functools.lru_cache(maxsize=None)
def _const(name: str, order: int, arg, dtype, device) -> torch.Tensor:
    """Cached device copy of a small host constant (one upload per key).

    A tensor created inside a ``torch.func`` transform is wrapped at that
    transform's level and must not outlive it, so the cached copy is
    unwrapped to the plain tensor underneath.
    """
    a = blending_matrix(order, arg) if name == "blend" else _deriv_factors(order, arg)
    t = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def u_powers(u: torch.Tensor, order: int, deriv: int = 0) -> torch.Tensor:
    """Vector [d^deriv/du^deriv u^n for n in 0..order-1], shape (order,)."""
    f = _const("deriv", order, deriv, u.dtype, u.device)
    # u^0 .. u^{order-1} by repeated products (the cumprod of the JAX code).
    pows = [torch.ones_like(u)]
    cur = u
    for _ in range(1, order):
        pows.append(cur)
        cur = cur * u
    ks = np.maximum(np.arange(order) - deriv, 0)
    return f * torch.stack([pows[k] for k in ks], dim=-1)


def spline_coords(t: torch.Tensor, t0, dt, num_knots: int, order: int):
    """Map times to (segment index, local coordinate u).

    The segment index is clipped to the valid range; callers mask
    out-of-range measurements themselves.
    """
    s = (t - t0) / dt
    i = torch.clamp(torch.floor(s), 0, num_knots - order).to(torch.int64)
    u = s - i.to(s.dtype)
    return i, u


def gather_window(knots: torch.Tensor, idx: torch.Tensor, order: int) -> torch.Tensor:
    """knots (K, ...), idx (...,) -> windows (..., order, ...)."""
    offs = torch.arange(order, dtype=idx.dtype, device=idx.device)
    return knots[idx[..., None] + offs]


# ---------------------------------------------------------------------------
# Euclidean spline
# ---------------------------------------------------------------------------

def r3_eval(window: torch.Tensor, u: torch.Tensor, dt, deriv: int = 0,
            order: int | None = None) -> torch.Tensor:
    """Evaluate an R^d spline (or its time derivative) on one knot window.

    window: (N, d); u: scalar; returns (d,). The ``deriv``-th time
    derivative includes the 1/dt^deriv factor.
    """
    n = order if order is not None else window.shape[-2]
    M = _const("blend", n, False, window.dtype, window.device)
    coeff = M @ u_powers(u, n, deriv)  # (N,)
    out = torch.einsum("n,nd->d", coeff, window)
    if deriv:
        out = out / (dt ** deriv)
    return out


# ---------------------------------------------------------------------------
# Cumulative SO(3) spline
# ---------------------------------------------------------------------------

def so3_eval(qwindow: torch.Tensor, u: torch.Tensor, order: int | None = None) -> torch.Tensor:
    """Cumulative Lie-group spline value: unit quaternion at local coord u.

    q(u) = q_i ⊗ prod_{j=1}^{N-1} exp(lam_j(u) * log(q_{i+j-1}^{-1} q_{i+j})).
    qwindow: (N, 4); returns (4,).
    """
    n = order if order is not None else qwindow.shape[-2]
    Mc = _const("blend", n, True, qwindow.dtype, qwindow.device)
    lam = Mc @ u_powers(u, n)  # (N,), lam[0] == 1 identically
    d = lie.so3_log(lie.quat_multiply(lie.quat_conjugate(qwindow[:-1]), qwindow[1:]))
    q = qwindow[0]
    for j in range(1, n):
        q = lie.quat_multiply(q, lie.so3_exp(lam[j] * d[j - 1]))
    return q


def so3_vel(qwindow: torch.Tensor, u: torch.Tensor, dt, order: int | None = None):
    """(q(u), body-frame angular velocity omega) at local coord u.

    omega_body = 2 * vec(q^{-1} ⊗ dq/dt) from quaternion kinematics
    dq/dt = 0.5 q ⊗ [0, omega_body]; dq/du obtained by jvp.
    """
    q, dq_du = jvp(lambda uu: so3_eval(qwindow, uu, order), (u,), (torch.ones_like(u),))
    omega = 2.0 * lie.quat_multiply(lie.quat_conjugate(q), dq_du)[..., 1:4] / dt
    return q, omega


def so3_accel(qwindow: torch.Tensor, u: torch.Tensor, dt, order: int | None = None):
    """(q, omega, domega/dt) — body-frame angular velocity and acceleration."""
    def vel_fn(uu):
        return so3_vel(qwindow, uu, dt, order)

    (q, omega), (_, domega_du) = jvp(vel_fn, (u,), (torch.ones_like(u),))
    return q, omega, domega_du / dt


# ---------------------------------------------------------------------------
# Batched convenience wrappers (vmap over measurements)
# ---------------------------------------------------------------------------

def r3_eval_batch(knots: torch.Tensor, t: torch.Tensor, t0, dt, deriv: int = 0,
                  order: int = 6) -> torch.Tensor:
    """knots (K, d), t (M,) -> (M, d)."""
    idx, u = spline_coords(t, t0, dt, knots.shape[0], order)
    windows = gather_window(knots, idx, order)  # (M, N, d)
    return vmap(lambda w, uu: r3_eval(w, uu, dt, deriv, order))(windows, u)


def so3_eval_batch(qknots: torch.Tensor, t: torch.Tensor, t0, dt, order: int = 6) -> torch.Tensor:
    idx, u = spline_coords(t, t0, dt, qknots.shape[0], order)
    windows = gather_window(qknots, idx, order)
    return vmap(lambda w, uu: so3_eval(w, uu, order))(windows, u)


def so3_vel_batch(qknots: torch.Tensor, t: torch.Tensor, t0, dt, order: int = 6):
    idx, u = spline_coords(t, t0, dt, qknots.shape[0], order)
    windows = gather_window(qknots, idx, order)
    return vmap(lambda w, uu: so3_vel(w, uu, dt, order))(windows, u)
