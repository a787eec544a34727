"""Block-tridiagonal + arrowhead damped solve for the spline normal equations.

Port of ``solver/banded.py`` of the JAX package. Every residual of the
continuous-time problem touches at most ORDER contiguous SO3 knots, ORDER
contiguous R3 knots and a small set of global parameters, so the Hessian
is block-banded over time plus a dense "arrow" of global parameters. The
knot coordinates are grouped into TIME SLABS; measurement windows then
couple only ADJACENT slabs, so the knot-knot block is block-tridiagonal
over slabs and factorizes with a loop of small per-slab Cholesky and
triangular solves, O(D * slab^2) instead of O(D^3 / 3). The global tail is
handled by a Schur complement: one block-tridiagonal solve with (tail + 1)
right-hand sides, a small dense tail solve, one back-substitution.

The structure is host numpy, verified against the problem's actual
measurement windows by ``from_problem``. The solve is plain PyTorch on
H's device: the JAX ``lax.scan`` over slabs is a Python loop here (one
small Cholesky / triangular solve per slab). A factorization that fails
(not positive definite) gives NaNs, as ``jnp.linalg.cholesky`` does, so
the LM loop rejects the step instead of raising.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SlabStructure(NamedTuple):
    """Static (host-side) slab decomposition of the tangent space."""

    idx: np.ndarray      # (K, smax) int32 tangent coords per slab (pad -> 0)
    valid: np.ndarray    # (K, smax) bool
    tail: np.ndarray     # (De,) int32 tangent coords of the arrow tail
    tangent_dim: int


def build_structure(layout, n_so3: int, n_r3: int, dt_so3: float,
                    dt_r3: float, slab_time: float) -> SlabStructure:
    """Group so3/r3 knot coordinates into time slabs of width slab_time.

    Knot i of a spline with spacing dt supports t in
    [t0 + (i - ORDER + 1) dt, t0 + (i + 1) dt); slab membership uses the
    knot's anchor time i*dt (monotone in i, so slabs are contiguous index
    ranges)."""
    off_s = layout.offsets["q_so3"]
    off_r = layout.offsets["t_r3"]
    ks = (np.arange(n_so3) * dt_so3 / slab_time).astype(np.int64)
    kr = (np.arange(n_r3) * dt_r3 / slab_time).astype(np.int64)
    nslab = int(max(ks.max(), kr.max())) + 1
    slabs = []
    for k in range(nslab):
        coords = []
        for i in np.nonzero(ks == k)[0]:
            coords.extend(off_s + 3 * i + np.arange(3))
        for i in np.nonzero(kr == k)[0]:
            coords.extend(off_r + 3 * i + np.arange(3))
        slabs.append(np.asarray(coords, np.int32))
    smax = max(len(c) for c in slabs)
    idx = np.zeros((nslab, smax), np.int32)
    valid = np.zeros((nslab, smax), bool)
    for k, c in enumerate(slabs):
        idx[k, :len(c)] = c
        valid[k, :len(c)] = True
    band = set(int(x) for c in slabs for x in c)
    tail = np.asarray([d for d in range(layout.tangent_dim)
                       if d not in band], np.int32)
    return SlabStructure(idx=idx, valid=valid, tail=tail,
                         tangent_dim=layout.tangent_dim)


def _windows_adjacent(struct: SlabStructure, n_so3, n_r3, dt_so3, dt_r3,
                      slab_time, times, order) -> bool:
    """Host check: every measurement window at the given times couples
    only coordinates of the same or adjacent slabs."""
    t = np.asarray(times, np.float64)
    i_s = np.clip(np.floor(t / dt_so3), 0, n_so3 - order).astype(np.int64)
    i_r = np.clip(np.floor(t / dt_r3), 0, n_r3 - order).astype(np.int64)
    ks_lo = (i_s * dt_so3 / slab_time).astype(np.int64)
    ks_hi = ((i_s + order - 1) * dt_so3 / slab_time).astype(np.int64)
    kr_lo = (i_r * dt_r3 / slab_time).astype(np.int64)
    kr_hi = ((i_r + order - 1) * dt_r3 / slab_time).astype(np.int64)
    lo = np.minimum(ks_lo, kr_lo)
    hi = np.maximum(ks_hi, kr_hi)
    return bool(np.all(hi - lo <= 1))


def _host_times(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def from_problem(layout, p, order: int, margin: float = 1.3):
    """SlabStructure for a SplineProblem, with slab width chosen so the
    adjacency property provably holds for ITS measurement times; returns
    None when no valid decomposition exists below one-slab degeneracy
    (callers fall back to the dense solve). Reads the problem's time
    tensors to the host once."""
    # Times are relative to t0 in the window computation.
    times = np.concatenate([_host_times(p.accel_t), _host_times(p.gyro_t),
                            _host_times(p.obs_t)]) - p.t0
    slab_time = margin * order * max(p.dt_so3, p.dt_r3)
    dur = max((p.n_so3 - 1) * p.dt_so3, (p.n_r3 - 1) * p.dt_r3)
    while slab_time < dur:
        if _windows_adjacent(None, p.n_so3, p.n_r3, p.dt_so3, p.dt_r3,
                             slab_time, times, order):
            struct = build_structure(layout, p.n_so3, p.n_r3, p.dt_so3,
                                     p.dt_r3, slab_time)
            if struct.idx.shape[0] >= 3:
                return struct
            return None  # <3 slabs: dense is as good
        slab_time *= 1.5
    return None


def _tri_solve(L, B, trans=False):
    """L^{-1} B (or L^{-T} B) for a lower-triangular L."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def _cholesky_or_nan(A):
    """Lower Cholesky factor of A, all NaN where A is not positive definite
    (``jnp.linalg.cholesky``'s contract; no host sync)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def make_banded_solver(struct: SlabStructure):
    """Returns ``solve_fn(H, g, lam) -> delta`` for lm.lm_optimize.

    Contract identical to lm._solve_damped: solves
    (Hs + lam I) y = -(s g) on the Jacobi-scaled system (s = rsqrt(diag H))
    and returns s*y, with one iterative-refinement pass. The factorization
    is block-tridiagonal over slabs + dense Schur complement on the tail.
    Index tensors are moved to H's device on first use.
    """
    K, smax = struct.idx.shape
    cache: dict = {}

    def _consts(device, dt):
        key = (str(device), dt)
        if key not in cache:
            cache[key] = (torch.as_tensor(struct.idx.astype(np.int64), device=device),
                          torch.as_tensor(struct.valid, device=device).to(dt),
                          torch.as_tensor(struct.tail.astype(np.int64), device=device))
        return cache[key]

    def _band_sub(Ls, Lsubs, R, v):
        """Forward+backward substitution through the block-bidiagonal
        Cholesky factor for stacked rhs R (K, smax, m)."""
        y_prev = torch.zeros_like(R[0])
        Ys = []
        for k in range(K):
            y_prev = _tri_solve(Ls[k], R[k] - Lsubs[k] @ y_prev)
            Ys.append(y_prev)
        # L_{k+1,k} couples x_k to the y-terms of k+1.
        x_next = torch.zeros_like(R[0])
        Xs = [None] * K
        for k in range(K - 1, -1, -1):
            rhs = Ys[k] if k == K - 1 else Ys[k] - Lsubs[k + 1].mT @ x_next
            x_next = _tri_solve(Ls[k], rhs, trans=True)
            Xs[k] = x_next
        return torch.stack(Xs) * v[:, :, None]

    def _factor(Hd, idx, v, tail):
        """Factor once: block-tridiagonal Cholesky of the slab system plus
        the tail Schur complement. Returns everything substitution needs."""
        dt = Hd.dtype
        eye = torch.eye(smax, dtype=dt, device=Hd.device)
        # Gather slab blocks (static index tensors).
        A = Hd[idx[:, :, None], idx[:, None, :]]
        A = A * v[:, :, None] * v[:, None, :] + eye * (1.0 - v)[:, :, None]
        B = Hd[idx[1:, :, None], idx[:-1, None, :]]
        B = B * v[1:, :, None] * v[:-1, None, :]
        L_prev = eye
        Ls, Lsubs = [], [torch.zeros_like(eye)]
        for k in range(K):
            if k:
                Lsub = _tri_solve(L_prev, B[k - 1].mT).mT  # B_k L_prev^{-T}
                Lsubs.append(Lsub)
                S_k = A[k] - Lsub @ Lsub.mT
            else:
                # B_0 = 0: the JAX scan's first step subtracts an exact zero.
                S_k = A[0]
            L_prev = _cholesky_or_nan(S_k)
            Ls.append(L_prev)

        CT = Hd[idx[:, :, None], tail[None, None, :]] * v[:, :, None]
        Xc = _band_sub(Ls, Lsubs, CT, v)           # T^{-1} C
        E = Hd[tail[:, None], tail[None, :]]
        S = E - torch.einsum("ksd,kse->de", CT, Xc)
        Lt = _cholesky_or_nan(S)
        return Ls, Lsubs, CT, Xc, Lt

    def _substitute(factors, b, idx, v, tail):
        Ls, Lsubs, CT, Xc, Lt = factors
        Rs = (b[idx] * v)[:, :, None]
        Xr = _band_sub(Ls, Lsubs, Rs, v)
        rhs_t = b[tail][:, None] - torch.einsum("ksd,ksm->dm", CT, Xr)
        Xt = torch.cholesky_solve(rhs_t, Lt)
        Xb = Xr - torch.einsum("ksd,dm->ksm", Xc, Xt)
        y = torch.zeros((struct.tangent_dim,), dtype=b.dtype, device=b.device)
        y.index_add_(0, idx.reshape(-1), (Xb[..., 0] * v).reshape(-1))
        y[tail] = Xt[:, 0]
        return y

    def solve_fn(H, g, lam):
        idx, v, tail = _consts(H.device, H.dtype)
        d = torch.diagonal(H)
        s = torch.rsqrt(torch.clamp(d, min=1e-12))
        Hd = H * s[:, None] * s[None, :]
        # Hs + lam I: the diagonal add alone (adding lam * 0 elsewhere is
        # exact), so no second D x D temporary.
        Hd.diagonal().add_(lam)
        b = -(s * g)

        factors = _factor(Hd, idx, v, tail)
        y = _substitute(factors, b, idx, v, tail)
        # One iterative-refinement pass REUSING the factorization
        # (mirrors lm._solve_damped's refinement; recovers f32 bits).
        r = Hd @ y - b
        y = y + _substitute(factors, -r, idx, v, tail)
        return s * y

    return solve_fn
