"""Levenberg-Marquardt core with a host-driven loop.

Port of ``solver/lm.py`` of the JAX package. The JAX package runs the
whole loop as one ``lax.while_loop``; here the loop runs on the host and
reads one small tensor per trial step (whether the trial was accepted,
and whether it converged). Everything else — the damped solve, the
retraction, the linearization — stays on the device, and the state
updates mirror the JAX loop's ``where`` selections term by term, so on the
same problem both give the same iteration count, status and cost history
(Ceres semantics: every trial step counts as an iteration in the fused
loop).

* ``linearize_fn(params) -> (H, g, cost)`` returns dense normal equations.
* Damping is Marquardt-style on the Jacobi-equilibrated system; rejected
  steps retry with a larger lambda without re-linearizing (classic) or
  with gain-ratio (Nielsen) damping (fused).
* Fixed parameters are a 0/1 mask over the tangent vector (see
  ``blocks.BlockLayout.free_mask``); masked coordinates get an identity
  diagonal so the dense Cholesky stays well-posed.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd


class LMConfig(NamedTuple):
    max_iters: int = 50
    lam0: float = 1e-4
    lam_down: float = 1.0 / 3.0
    lam_up: float = 4.0
    lam_min: float = 1e-12
    lam_max: float = 1e10
    ftol: float = 1e-6
    max_inner: int = 8
    history_len: int = 64  # size of the recorded cost trace


# Termination statuses.
STATUS_MAX_ITERS = 0  # iteration cap hit while still making progress
STATUS_CONVERGED = 1  # accepted step with relative decrease < ftol
STATUS_NO_PROGRESS = 2  # no damping retry produced a decrease

STATUS_NAMES = {STATUS_MAX_ITERS: "NO_CONVERGENCE",
                STATUS_CONVERGED: "CONVERGENCE",
                STATUS_NO_PROGRESS: "TRUST_REGION_EXHAUSTED"}


class LMResult(NamedTuple):
    params: dict
    cost: torch.Tensor
    iterations: int
    lam: torch.Tensor
    converged: bool  # status == STATUS_CONVERGED
    status: int = STATUS_MAX_ITERS
    # cost after each outer iteration, NaN beyond ``iterations``
    cost_history: torch.Tensor | None = None
    # host wall time of the loop (it ends on a device sync) and the number
    # of linearize_fn calls it made
    seconds: float = 0.0
    linearizations: int = 0


def _mask_system(H, g, mask):
    """Zero fixed rows/cols of H and g; unit diagonal on fixed coords."""
    Hm = H * mask[:, None] * mask[None, :]
    Hm = Hm + torch.diag(1.0 - mask)
    return Hm, g * mask


def _default_mask_fn(H, g, m):
    return _mask_system(H, g, m.to(g.dtype))


def _solve_damped(H, g, lam):
    """Solve (H + lam * diag(H)) delta = -g via Jacobi-equilibrated Cholesky.

    Scaling H to unit diagonal first keeps the factorization well-
    conditioned in float32 (the damped system becomes Hs + lam*I with
    diag(Hs) = 1); one step of iterative refinement against the same
    factorization recovers most of the bits float32 loses at
    calibration-problem conditioning. If the factorization fails the
    solution is NaN and the LM step is rejected (no host sync here).
    """
    d = torch.diagonal(H)
    s = torch.rsqrt(torch.clamp(d, min=1e-12))
    Hs = H * s[:, None] * s[None, :]
    Hd = Hs + lam * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(Hd)
    b = -(s * g)
    y = torch.cholesky_solve(b[:, None], L)[:, 0]
    r = Hd @ y - b
    y = y - torch.cholesky_solve(r[:, None], L)[:, 0]
    out = s * y
    return torch.where(info == 0, out, torch.full_like(out, float("nan")))


def _record(hist, it, value, history_len):
    """Keep the first ``history_len`` entries; later ones leave the trace."""
    if it < history_len:
        hist[it] = value


def lm_optimize(
    linearize_fn: Callable,
    cost_fn: Callable,
    retract_fn: Callable,
    params0: dict,
    free_mask: torch.Tensor,
    config: LMConfig = LMConfig(),
    *,
    solve_fn: Callable | None = None,
    mask_fn: Callable | None = None,
    strategy: str = "classic",
) -> LMResult:
    """Run LM; params are a dict of tensors.

    ``strategy``:

    * "classic" — linearize once per outer iteration, then an inner
      damping loop of (solve, retract, cost_fn) trials.
    * "fused" — the trial cost comes from ``linearize_fn(candidate)``, so
      an accepted trial's linearization is the next iteration's normal
      equations and ``cost_fn`` is unused. Every trial counts as an
      iteration; damping is gain-ratio (Nielsen).
    """
    cfg = config
    if strategy == "fused":
        return _lm_optimize_fused(linearize_fn, retract_fn, params0,
                                  free_mask, cfg, solve_fn=solve_fn,
                                  mask_fn=mask_fn)
    if strategy != "classic":
        raise ValueError(f"unknown LM strategy: {strategy!r}")
    mask_fn = mask_fn or _default_mask_fn
    solve_fn = solve_fn or _solve_damped

    t_start = time.perf_counter()
    cost0 = cost_fn(params0)
    dtype, device = cost0.dtype, cost0.device
    fmask = free_mask.to(dtype)
    lam = torch.as_tensor(cfg.lam0, dtype=dtype, device=device)
    hist = torch.full((cfg.history_len,), float("nan"), dtype=dtype, device=device)
    params, cost, it, status = params0, cost0, 0, STATUS_MAX_ITERS
    while it < cfg.max_iters and status == STATUS_MAX_ITERS:
        H, g, cost_lin = linearize_fn(params)
        H, g = mask_fn(H, g, free_mask)
        denom = torch.clamp(cost_lin, min=1e-20)
        best_params, best_cost, lam_i = params, cost_lin, lam
        accepted, converged, tries = False, False, 0
        while not accepted and tries < cfg.max_inner:
            delta = solve_fn(H, g, lam_i) * fmask
            cand = retract_fn(params, delta)
            cand_cost = cost_fn(cand)
            good_t = torch.isfinite(cand_cost) & (cand_cost < cost_lin)
            conv_t = good_t & ((cost_lin - cand_cost) / denom < cfg.ftol)
            good, conv = (bool(v) for v in torch.stack([good_t, conv_t]).tolist())
            if good:
                lam_i = torch.clamp(lam_i * cfg.lam_down, min=cfg.lam_min)
                best_params, best_cost = cand, cand_cost
            else:
                lam_i = torch.clamp(lam_i * cfg.lam_up, max=cfg.lam_max)
            accepted, converged = good, conv
            tries += 1
        status = (STATUS_CONVERGED if converged else
                  STATUS_MAX_ITERS if accepted else STATUS_NO_PROGRESS)
        _record(hist, it, best_cost, cfg.history_len)
        params, cost, lam = best_params, best_cost, lam_i
        it += 1
    return LMResult(params, cost, it, lam, status == STATUS_CONVERGED,
                    status, hist, time.perf_counter() - t_start, it)


def _solve_damped_lanes(H, g, lam):
    """:func:`_solve_damped` for a stack of independent systems: H (L, D, D),
    g (L, D), lam (L,); a lane whose factorization fails gets NaNs."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp(d, min=1e-12))
    Hs = H * s[:, :, None] * s[:, None, :]
    Hd = Hs + lam[:, None, None] * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(Hd)
    b = -(s * g)
    y = torch.cholesky_solve(b[..., None], L)[..., 0]
    r = (Hd @ y[..., None])[..., 0] - b
    y = y - torch.cholesky_solve(r[..., None], L)[..., 0]
    out = s * y
    return torch.where(info[:, None] == 0, out, torch.full_like(out, float("nan")))


def _select(mask, a: dict, b: dict) -> dict:
    """Per lane: ``a`` where ``mask`` (L,), else ``b``."""
    return {k: torch.where(mask.reshape((-1,) + (1,) * (a[k].ndim - 1)), a[k], b[k])
            for k in a}


def lm_optimize_lanes(
    linearize_fn: Callable,
    cost_fn: Callable,
    retract_fn: Callable,
    params0: dict,
    free_mask: torch.Tensor,
    config: LMConfig = LMConfig(),
) -> LMResult:
    """The classic loop of :func:`lm_optimize` on L independent problems
    at once, as ``vmap(lm_optimize)`` runs in the JAX package: each lane
    keeps its own damping, iteration count and status, and a lane that
    has stopped keeps its state while the others go on.

    ``linearize_fn(params) -> (H (L, D, D), g (L, D), cost (L,))``,
    ``cost_fn(params) -> (L,)`` and ``retract_fn(params, delta (L, D))``
    act on lane-stacked parameter dicts; ``free_mask`` is (L, D). Returns
    an ``LMResult`` whose cost, iterations, lam and status are per lane
    ((L,) tensors; ``cost_history`` is (L, history_len)).
    """
    cfg = config
    t_start = time.perf_counter()
    cost0 = cost_fn(params0)
    dtype, device = cost0.dtype, cost0.device
    n_lanes = cost0.shape[0]
    fmask = free_mask.to(dtype)
    lam = torch.full((n_lanes,), cfg.lam0, dtype=dtype, device=device)
    hist = torch.full((n_lanes, cfg.history_len), float("nan"), dtype=dtype, device=device)
    it = torch.zeros(n_lanes, dtype=torch.int64, device=device)
    status = torch.full((n_lanes,), STATUS_MAX_ITERS, dtype=torch.int64, device=device)
    params, cost = params0, cost0
    eye = torch.eye(fmask.shape[-1], dtype=dtype, device=device)
    n_lin = 0
    active = (it < cfg.max_iters) & (status == STATUS_MAX_ITERS)
    while bool(active.any()):
        H, g, cost_lin = linearize_fn(params)
        n_lin += 1
        H = H * fmask[:, :, None] * fmask[:, None, :] + eye * (1.0 - fmask)[:, None, :]
        g = g * fmask
        denom = torch.clamp(cost_lin, min=1e-20)
        best_params, best_cost, lam_i = params, cost_lin, lam
        accepted = torch.zeros_like(active)
        converged = torch.zeros_like(active)
        tries = torch.zeros_like(it)
        trying = active.clone()
        while bool(trying.any()):
            delta = _solve_damped_lanes(H, g, lam_i) * fmask
            cand = retract_fn(params, delta)
            cand_cost = cost_fn(cand)
            good = torch.isfinite(cand_cost) & (cand_cost < cost_lin)
            conv = good & ((cost_lin - cand_cost) / denom < cfg.ftol)
            lam_new = torch.where(good, torch.clamp(lam_i * cfg.lam_down, min=cfg.lam_min),
                                  torch.clamp(lam_i * cfg.lam_up, max=cfg.lam_max))
            lam_i = torch.where(trying, lam_new, lam_i)
            take = trying & good
            best_params = _select(take, cand, best_params)
            best_cost = torch.where(take, cand_cost, best_cost)
            accepted = torch.where(trying, good, accepted)
            converged = torch.where(trying, conv, converged)
            tries = tries + trying.to(tries.dtype)
            trying = active & ~accepted & (tries < cfg.max_inner)
        new_status = torch.where(converged, STATUS_CONVERGED,
                                 torch.where(accepted, STATUS_MAX_ITERS, STATUS_NO_PROGRESS))
        rec = active & (it < cfg.history_len)
        lane = torch.arange(n_lanes, device=device)
        hist[lane[rec], it[rec]] = best_cost[rec]
        params = _select(active, best_params, params)
        cost = torch.where(active, best_cost, cost)
        lam = torch.where(active, lam_i, lam)
        status = torch.where(active, new_status, status)
        it = it + active.to(it.dtype)
        active = (it < cfg.max_iters) & (status == STATUS_MAX_ITERS)
    return LMResult(params, cost, it, lam, status == STATUS_CONVERGED, status, hist,
                    time.perf_counter() - t_start, n_lin)


def _predicted_decrease(H, g, delta):
    """-(g . d + 0.5 d.H.d) for a dense masked system; None for any other
    form of H, where the caller falls back to multiplicative damping."""
    if isinstance(H, torch.Tensor) and H.ndim == 2:
        return -(torch.dot(g, delta) + 0.5 * torch.dot(delta, H @ delta))
    return None


def _lm_optimize_fused(
    linearize_fn: Callable,
    retract_fn: Callable,
    params0: dict,
    free_mask: torch.Tensor,
    cfg: LMConfig,
    *,
    solve_fn: Callable | None = None,
    mask_fn: Callable | None = None,
) -> LMResult:
    """Fused trial loop: see :func:`lm_optimize` (strategy="fused")."""
    mask_fn = mask_fn or _default_mask_fn
    solve_fn = solve_fn or _solve_damped

    t_start = time.perf_counter()
    H, g, cost = linearize_fn(params0)
    H, g = mask_fn(H, g, free_mask)
    dtype, device = cost.dtype, cost.device
    fmask = free_mask.to(dtype)
    lam = torch.as_tensor(cfg.lam0, dtype=dtype, device=device)
    nu = 2.0
    hist = torch.full((cfg.history_len,), float("nan"), dtype=dtype, device=device)
    params, it, rejects, status = params0, 0, 0, STATUS_MAX_ITERS
    while (it < cfg.max_iters and status == STATUS_MAX_ITERS
           and rejects < cfg.max_inner):
        delta = solve_fn(H, g, lam) * fmask
        cand = retract_fn(params, delta)
        Hc, gc, cost_c = linearize_fn(cand)
        Hc, gc = mask_fn(Hc, gc, free_mask)
        good_t = torch.isfinite(cost_c) & (cost_c < cost)
        rel_decrease = (cost - cost_c) / torch.clamp(cost, min=1e-20)
        conv_t = good_t & (rel_decrease < cfg.ftol)
        good, conv = (bool(v) for v in torch.stack([good_t, conv_t]).tolist())

        if good:
            pred = _predicted_decrease(H, g, delta)
            if pred is not None:
                rho = (cost - cost_c) / torch.clamp(pred, min=1e-20)
                shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
                lam = torch.clamp(lam * shrink, cfg.lam_min, cfg.lam_max)
            else:
                lam = torch.clamp(lam * cfg.lam_down, min=cfg.lam_min)
            nu = 2.0
            params, cost, H, g = cand, cost_c, Hc, gc
            rejects = 0
        else:
            lam = torch.clamp(lam * nu, max=cfg.lam_max)
            nu = nu * 2.0
            rejects += 1
        status = STATUS_CONVERGED if conv else STATUS_MAX_ITERS
        _record(hist, it, cost, cfg.history_len)
        it += 1
    if status == STATUS_MAX_ITERS and rejects >= cfg.max_inner:
        status = STATUS_NO_PROGRESS
    return LMResult(params, cost, it, lam, status == STATUS_CONVERGED,
                    status, hist, time.perf_counter() - t_start, it + 1)


def make_dense_linearizer(residual_fn: Callable, layout, weight_fn: Callable | None = None):
    """Build (linearize_fn, cost_fn, retract_fn) from a flat residual function.

    ``residual_fn(params) -> (M,)`` whitened residuals. ``weight_fn(r) ->
    (M,)`` optional IRLS sqrt-weights (see robust.huber_sqrt_weights),
    recomputed each outer iteration and held constant during the step
    (computed outside the transform and detached). The Jacobian comes
    from ``torch.func.jacfwd`` over the tangent delta: suitable for
    tangent dims up to a few thousand.
    """
    def weighted_residual(params):
        r = residual_fn(params)
        if weight_fn is not None:
            r = r * weight_fn(r).detach()
        return r

    def cost_fn(params):
        r = weighted_residual(params)
        return 0.5 * torch.sum(r * r)

    def linearize_fn(params):
        r = residual_fn(params)
        w = (weight_fn(r) if weight_fn is not None else torch.ones_like(r)).detach()

        def r_of_delta(delta):
            return residual_fn(layout.retract(params, delta)) * w

        delta0 = torch.zeros((layout.tangent_dim,), dtype=r.dtype, device=r.device)
        J = jacfwd(r_of_delta)(delta0)  # (M, D)
        rw = r * w
        return J.T @ J, J.T @ rw, 0.5 * torch.sum(rw * rw)

    return linearize_fn, cost_fn, layout.retract
