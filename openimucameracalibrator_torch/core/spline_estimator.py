"""Continuous-time B-spline IMU+camera batch calibration.

Port of ``core/spline_estimator.py`` of the JAX package. The trajectory is
a split cumulative SO(3) x R^3 uniform B-spline (order 6) with order-3 bias
splines, gravity, T_imu_cam, time offset and rolling-shutter line delay as
parameters.

* Measurements live in three batches (accelerometer, gyroscope,
  per-observation reprojection). Each measurement touches a fixed window
  of knots, so its Jacobian w.r.t. a LOCAL tangent vector (<= 54 dims) is
  a small dense block, computed by ``torch.func.vmap`` of
  ``torch.func.jacfwd`` / ``jacrev``.
* The fast linearizer (:func:`make_fast_linearizer`) cuts each time-sorted
  family into chunks; every chunk touches a local window of knots, so its
  normal equations are a small dense ``(L, L)`` block, built by the fused
  densify + Gram kernel (``solver/gram.py``; a hand-written CUDA kernel on
  the card). The blocks are summed into the global ``(D, D)`` system by
  one ``index_add_`` over a flat index planned once on the host.
* Parameter fixing is a 0/1 mask over the tangent vector.
* Rolling shutter: each observation's capture time is t_frame +
  line_delay * row. The knot-window index uses the detached capture time,
  so gathers stay fixed while the in-segment coordinate u keeps the
  line-delay gradient.
* The fast linearizer's variants serve the multi-sequence batch
  (``core/batch_estimator.py``: N stacked problems, per-problem scalar
  overrides) and the sharded solvers (``parallel/sharded.py``,
  ``parallel/schur.py``: per-shard chunk bases, knot-window origins).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jacrev, vmap

from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.ops import interpolation, lie, spline
from openimucameracalibrator_torch.solver import blocks, gram, lm, robust
from openimucameracalibrator_torch.utils import precision
from openimucameracalibrator_torch.utils.types import (CameraCalibration, CornerDataset,
                                                       ImuData, PoseDataset,
                                                       SplineWeightingData)

ORDER = 6  # SPLINE_N
BIAS_ORDER = 3  # BIAS_SPLINE_N
HUBER_PX = 1.345

# Optimization flag names (SplineOptimFlags equivalent).
SPLINE = "spline"
T_I_C = "t_i_c"
IMU_BIASES = "imu_biases"
GRAVITY_DIR = "gravity"
CAM_LINE_DELAY = "line_delay"
IMU_INTRINSICS = "imu_intrinsics"
ACC_BIAS = "acc_bias"
GYR_BIAS = "gyr_bias"
TIME_OFFSET = "time_offset"
POINTS = "points"
DEFAULT_FLAGS = frozenset({SPLINE, T_I_C, IMU_BIASES, GRAVITY_DIR})


class SplineProblem(NamedTuple):
    """Measurement batches + spline metadata (all times IMU clock)."""

    t0: float
    dt_so3: float
    dt_r3: float
    dt_bias: float
    n_so3: int
    n_r3: int
    n_bias: int
    # accelerometer
    accel_t: torch.Tensor  # (Ma,)
    accel_meas: torch.Tensor  # (Ma, 3)
    accel_valid: torch.Tensor  # (Ma,) bool
    w_accel: float  # 1/std_r3
    # gyroscope
    gyro_t: torch.Tensor
    gyro_meas: torch.Tensor
    gyro_valid: torch.Tensor
    w_gyro: float
    # reprojection (per observation)
    obs_t: torch.Tensor  # (Mo,) frame time
    obs_row: torch.Tensor  # (Mo,) pixel row (for RS)
    obs_uv: torch.Tensor  # (Mo, 2)
    obs_pt: torch.Tensor  # (Mo, 3) board point
    obs_valid: torch.Tensor  # (Mo,) bool
    cam_params: torch.Tensor
    model_name: str
    rolling_shutter: bool
    # board points as parameters + feature covariance (optional)
    n_points: int = 0
    obs_pt_id: torch.Tensor | None = None  # (Mo,) int64 index into points
    obs_sqrt_info: torch.Tensor | None = None  # (Mo, 2, 2)
    pt_prior_mean: torch.Tensor | None = None  # (P, 3)
    pt_prior_sqrt_info: torch.Tensor | None = None  # (P, 3, 3)
    # Upper bound of the valid measurement-time range (None: from knots).
    t_hi: float | None = None


def build_layout(p: SplineProblem) -> blocks.BlockLayout:
    """Global tangent layout. Block order keeps each measurement family's
    non-knot columns contiguous (accel -> bias_a|gravity|accl_intr, gyro
    -> bias_g|gyro_intr, reprojection -> q_i_c..time_offset), so a chunk's
    block lands in one placement per region pair."""
    specs = [
        blocks.BlockSpec("q_so3", (p.n_so3, 4), "quat"),
        blocks.BlockSpec("t_r3", (p.n_r3, 3)),
        blocks.BlockSpec("bias_a", (p.n_bias, 3)),
        blocks.BlockSpec("gravity", (3,)),
        blocks.BlockSpec("accl_intr", (6,)),
        blocks.BlockSpec("bias_g", (p.n_bias, 3)),
        blocks.BlockSpec("gyro_intr", (9,)),
        blocks.BlockSpec("q_i_c", (4,), "quat"),
        blocks.BlockSpec("t_i_c", (3,)),
        blocks.BlockSpec("line_delay", (1,)),
        blocks.BlockSpec("time_offset", (1,)),
    ]
    if p.n_points > 0:
        specs.append(blocks.BlockSpec("points", (p.n_points, 3)))
    return blocks.BlockLayout(specs)


def identity_accl_intr(dtype, device):
    """[mis_yz, mis_zy, mis_zx, sx, sy, sz]."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], dtype=dtype, device=device)


def identity_gyro_intr(dtype, device):
    """[mis_yz, mis_zy, mis_zx, mis_xz, mis_xy, mis_yx, sx, sy, sz]."""
    return torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0],
                        dtype=dtype, device=device)


def accl_intr_matrix(v):
    """T@K for the body-frame accelerometer triad: upper-triangular
    misalignment x scale."""
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([v[3], -v[0] * v[4], v[1] * v[5]]),
        torch.stack([z, v[4], -v[2] * v[5]]),
        torch.stack([z, z, v[5]]),
    ])


def gyro_intr_matrix(v):
    """T@K for the general gyroscope triad (full misalignment matrix)."""
    return torch.stack([
        torch.stack([v[6], -v[0] * v[7], v[1] * v[8]]),
        torch.stack([v[3] * v[6], v[7], -v[2] * v[8]]),
        torch.stack([-v[4] * v[6], v[5] * v[7], v[8]]),
    ])


def accl_intr_from(intr, dtype, device):
    """Pack a utils.types.ImuIntrinsics into the 6-vector accel parameter."""
    T, s = np.asarray(intr.misalignment), np.asarray(intr.scale)
    return torch.tensor([-T[0, 1], T[0, 2], -T[1, 2], s[0], s[1], s[2]],
                        dtype=dtype, device=device)


def gyro_intr_from(intr, dtype, device):
    """Pack a utils.types.ImuIntrinsics into the 9-vector gyro parameter."""
    T, s = np.asarray(intr.misalignment), np.asarray(intr.scale)
    return torch.tensor([-T[0, 1], T[0, 2], -T[1, 2], T[1, 0], -T[2, 0], T[2, 1],
                         s[0], s[1], s[2]], dtype=dtype, device=device)


def flags_to_fixed(flags: frozenset) -> list:
    fixed = []
    if SPLINE not in flags:
        fixed += ["q_so3", "t_r3"]
    if T_I_C not in flags:
        fixed += ["q_i_c", "t_i_c"]
    if IMU_BIASES not in flags and ACC_BIAS not in flags:
        fixed += ["bias_a"]
    if IMU_BIASES not in flags and GYR_BIAS not in flags:
        fixed += ["bias_g"]
    if GRAVITY_DIR not in flags:
        fixed += ["gravity"]
    if CAM_LINE_DELAY not in flags:
        fixed += ["line_delay"]
    if TIME_OFFSET not in flags:
        fixed += ["time_offset"]
    if IMU_INTRINSICS not in flags:
        fixed += ["accl_intr", "gyro_intr"]
    if POINTS not in flags:
        fixed += ["points"]
    return fixed


# ---------------------------------------------------------------------------
# Local residuals (one measurement, local tangent delta)
# ---------------------------------------------------------------------------

def _windows(p: SplineProblem, t):
    """Window indices + local coords for one time (all three splines)."""
    i_s, u_s = spline.spline_coords(t, p.t0, p.dt_so3, p.n_so3, ORDER)
    i_r, u_r = spline.spline_coords(t, p.t0, p.dt_r3, p.n_r3, ORDER)
    i_b, u_b = spline.spline_coords(t, p.t0, p.dt_bias, p.n_bias, BIAS_ORDER)
    return (i_s, u_s), (i_r, u_r), (i_b, u_b)


def _in_range(p: SplineProblem, t):
    hi_s = p.t0 + (p.n_so3 - ORDER + 1) * p.dt_so3
    hi_r = p.t0 + (p.n_r3 - ORDER + 1) * p.dt_r3
    ok = (t >= p.t0) & (t < hi_s) & (t < hi_r)
    if p.t_hi is not None:
        ok = ok & (t < p.t_hi)
    return ok


def accel_residual_local(delta, qwin, rwin, bwin, gravity, intr, meas,
                         u_s, u_r, u_b, p: SplineProblem):
    """Accelerometer residual: R(t)^T (a_w + g) - T K (raw - bias_a(t)).
    delta layout: [18 so3 | 18 r3 | 9 bias | 3 gravity | 6 intr] = 54."""
    qw = lie.quat_boxplus(qwin, delta[0:18].reshape(6, 3))
    rw = rwin + delta[18:36].reshape(6, 3)
    bw = bwin + delta[36:45].reshape(3, 3)
    g = gravity + delta[45:48]
    M = accl_intr_matrix(intr + delta[48:54])
    q = spline.so3_eval(qw, u_s, ORDER)
    a_w = spline.r3_eval(rw, u_r, p.dt_r3, 2, ORDER)
    bias = spline.r3_eval(bw, u_b, p.dt_bias, 0, BIAS_ORDER)
    r = lie.quat_rotate(lie.quat_conjugate(q), a_w + g) - M @ (meas - bias)
    return p.w_accel * r


def gyro_residual_local(delta, qwin, bwin, intr, meas, u_s, u_b, p: SplineProblem):
    """Gyroscope residual: omega_body(t) - T K (raw - bias_g(t)).
    delta layout: [18 so3 | 9 bias | 9 intr] = 36."""
    qw = lie.quat_boxplus(qwin, delta[0:18].reshape(6, 3))
    bw = bwin + delta[18:27].reshape(3, 3)
    M = gyro_intr_matrix(intr + delta[27:36])
    _, omega = spline.so3_vel(qw, u_s, p.dt_so3, ORDER)
    bias = spline.r3_eval(bw, u_b, p.dt_bias, 0, BIAS_ORDER)
    return p.w_gyro * (omega - M @ (meas - bias))


def reproj_residual_local(delta, qwin, rwin, q_ic, t_ic, ld, toff, t_frame, row, uv, pt,
                          u_s_fn, p: SplineProblem, sqrt_info=None):
    """Reprojection residual. delta layout:
    [18 so3 | 18 r3 | 3 q_ic | 3 t_ic | 1 ld | 1 toff (| 3 point)] = 44/47.

    ``u_s_fn(t)`` maps a capture time to in-segment coordinates, with the
    window index frozen by the caller. ``sqrt_info`` (2, 2) whitens the
    pixel residual. With ``p.n_points > 0`` the board point is a parameter.
    """
    qw = lie.quat_boxplus(qwin, delta[0:18].reshape(6, 3))
    rw = rwin + delta[18:36].reshape(6, 3)
    qic = lie.quat_boxplus(q_ic, delta[36:39])
    tic = t_ic + delta[39:42]
    ld_ = ld + delta[42]
    toff_ = toff + delta[43]
    if p.n_points > 0:
        pt = pt + delta[44:47]
    t_cap = t_frame + toff_ + (ld_ * row if p.rolling_shutter else 0.0)
    u_s, u_r = u_s_fn(t_cap)
    q_wi = spline.so3_eval(qw, u_s, ORDER)
    p_wi = spline.r3_eval(rw, u_r, p.dt_r3, 0, ORDER)
    q_wc, t_wc = lie.se3_compose(q_wi, p_wi, qic, tic)
    q_cw, t_cw = lie.se3_inverse(q_wc, t_wc)
    p_cam = lie.se3_act(q_cw, t_cw, pt)
    model = cameras.get_model(p.model_name)
    uv_pred, ok = model.project(p.cam_params, p_cam)
    r = uv_pred - uv
    if sqrt_info is not None:
        r = sqrt_info @ r
    # Invalid projection -> zero residual (solver-side mask).
    return torch.where(ok & (p_cam[2] > 1e-3), r, torch.zeros_like(r))


# ---------------------------------------------------------------------------
# Batched evaluation + assembly
# ---------------------------------------------------------------------------

def _value_and_jac(fn, n_batched: int, with_jac: bool, mode: str = "fwd"):
    """vmap over measurements of ``fn(delta, *args)`` at delta = 0.

    Returns ``run(d0, *args) -> (r, J or None)``; the Jacobian is taken
    w.r.t. the (unbatched) local tangent ``d0`` and the residual comes out
    of the same pass as its auxiliary value.
    """
    in_dims = (None,) + (0,) * n_batched
    if not with_jac:
        f = vmap(fn, in_dims=in_dims)
        return lambda d0, *a: (f(d0, *a), None)

    def with_aux(d, *a):
        out = fn(d, *a)
        return out, out

    jac = jacfwd if mode == "fwd" else jacrev
    f = vmap(jac(with_aux, has_aux=True), in_dims=in_dims)

    def run(d0, *a):
        J, r = f(d0, *a)
        return r, J

    return run


def _gather_accel(params, p: SplineProblem):
    (i_s, u_s), (i_r, u_r), (i_b, u_b) = _windows(p, p.accel_t)
    qwin = spline.gather_window(params["q_so3"], i_s, ORDER)
    rwin = spline.gather_window(params["t_r3"], i_r, ORDER)
    bwin = spline.gather_window(params["bias_a"], i_b, BIAS_ORDER)
    return qwin, rwin, bwin, (i_s, u_s), (i_r, u_r), (i_b, u_b)


def _accel_eval(params, p: SplineProblem, with_jac: bool):
    """(r, J, (i_s, i_r, i_b)) for all accelerometer measurements."""
    qwin, rwin, bwin, (i_s, u_s), (i_r, u_r), (i_b, u_b) = _gather_accel(params, p)
    w = (p.accel_valid & _in_range(p, p.accel_t)).to(p.accel_meas.dtype)

    def res(d, qw, rw, bw, m, us, ur, ub):
        return accel_residual_local(d, qw, rw, bw, params["gravity"],
                                    params["accl_intr"], m, us, ur, ub, p)

    d0 = torch.zeros((54,), dtype=p.accel_meas.dtype, device=p.accel_meas.device)
    r, J = _value_and_jac(res, 7, with_jac)(d0, qwin, rwin, bwin, p.accel_meas, u_s, u_r, u_b)
    r = r * w[:, None]
    if J is not None:
        J = J * w[:, None, None]
    return r, J, (i_s, i_r, i_b)


def _win_idx(layout, name, i0, order):
    """Global tangent indices of an order-window of a (K, d) block: (M, order*td)."""
    td = layout.by_name[name].tangent_shape[-1]
    ar = lambda n: torch.arange(n, dtype=i0.dtype, device=i0.device)  # noqa: E731
    base = layout.offsets[name] + (i0[:, None] + ar(order)) * td
    return (base[:, :, None] + ar(td)).reshape(i0.shape[0], order * td)


def _fixed_idx(layout, name, m, device):
    s = layout.slice_of(name)
    return torch.arange(s.start, s.stop, device=device).expand(m, s.stop - s.start)


def _accel_r_and_idx(params, p: SplineProblem, layout, with_jac: bool):
    r, J, (i_s, i_r, i_b) = _accel_eval(params, p, with_jac)
    m, dev = i_s.shape[0], i_s.device
    idx = torch.cat([
        _win_idx(layout, "q_so3", i_s, ORDER),
        _win_idx(layout, "t_r3", i_r, ORDER),
        _win_idx(layout, "bias_a", i_b, BIAS_ORDER),
        _fixed_idx(layout, "gravity", m, dev),
        _fixed_idx(layout, "accl_intr", m, dev),
    ], dim=1)
    return r, J, idx


def _gyro_eval(params, p: SplineProblem, with_jac: bool):
    """(r, J, (i_s, i_b)) for all gyroscope measurements."""
    (i_s, u_s), _, (i_b, u_b) = _windows(p, p.gyro_t)
    qwin = spline.gather_window(params["q_so3"], i_s, ORDER)
    bwin = spline.gather_window(params["bias_g"], i_b, BIAS_ORDER)
    w = (p.gyro_valid & _in_range(p, p.gyro_t)).to(p.gyro_meas.dtype)

    def res(d, qw, bw, m, us, ub):
        return gyro_residual_local(d, qw, bw, params["gyro_intr"], m, us, ub, p)

    d0 = torch.zeros((36,), dtype=p.gyro_meas.dtype, device=p.gyro_meas.device)
    r, J = _value_and_jac(res, 5, with_jac)(d0, qwin, bwin, p.gyro_meas, u_s, u_b)
    r = r * w[:, None]
    if J is not None:
        J = J * w[:, None, None]
    return r, J, (i_s, i_b)


def _gyro_r_and_idx(params, p: SplineProblem, layout, with_jac: bool):
    r, J, (i_s, i_b) = _gyro_eval(params, p, with_jac)
    m, dev = i_s.shape[0], i_s.device
    idx = torch.cat([
        _win_idx(layout, "q_so3", i_s, ORDER),
        _win_idx(layout, "bias_g", i_b, BIAS_ORDER),
        _fixed_idx(layout, "gyro_intr", m, dev),
    ], dim=1)
    return r, J, idx


def _reproj_eval(params, p: SplineProblem, with_jac: bool):
    """(r, J, (i_s, i_r)) for all reprojection observations; the Jacobian
    is taken in reverse mode (2 residual rows vs 44 tangent dims)."""
    ld = params["line_delay"][0]
    toff = params["time_offset"][0]
    t_cap0 = p.obs_t + toff.detach() + (ld.detach() * p.obs_row if p.rolling_shutter else 0.0)
    # Freeze window indices at the current line delay; u keeps the gradient.
    i_s, _ = spline.spline_coords(t_cap0, p.t0, p.dt_so3, p.n_so3, ORDER)
    i_r, _ = spline.spline_coords(t_cap0, p.t0, p.dt_r3, p.n_r3, ORDER)
    qwin = spline.gather_window(params["q_so3"], i_s, ORDER)
    rwin = spline.gather_window(params["t_r3"], i_r, ORDER)
    w = (p.obs_valid & _in_range(p, t_cap0)).to(p.obs_uv.dtype)
    pts = params["points"][p.obs_pt_id] if p.n_points > 0 else p.obs_pt
    d_dim = 47 if p.n_points > 0 else 44

    def res(d, qw, rw, tf, row, uv, pt, iis, iir, s2=None):
        def u_fn(t_cap):
            u_s = (t_cap - p.t0) / p.dt_so3 - iis.to(t_cap.dtype)
            u_r = (t_cap - p.t0) / p.dt_r3 - iir.to(t_cap.dtype)
            return u_s, u_r

        return reproj_residual_local(d, qw, rw, params["q_i_c"], params["t_i_c"],
                                     ld, toff, tf, row, uv, pt, u_fn, p, sqrt_info=s2)

    d0 = torch.zeros((d_dim,), dtype=p.obs_uv.dtype, device=p.obs_uv.device)
    args = [qwin, rwin, p.obs_t, p.obs_row, p.obs_uv, pts, i_s, i_r]
    if p.obs_sqrt_info is not None:
        args.append(p.obs_sqrt_info)
    r, J = _value_and_jac(res, len(args), with_jac, "rev")(d0, *args)
    r = r * w[:, None]
    if J is not None:
        J = J * w[:, None, None]
    return r, J, (i_s, i_r)


def _reproj_r_and_idx(params, p: SplineProblem, layout, with_jac: bool):
    r, J, (i_s, i_r) = _reproj_eval(params, p, with_jac)
    m, dev = i_s.shape[0], i_s.device
    parts = [
        _win_idx(layout, "q_so3", i_s, ORDER),
        _win_idx(layout, "t_r3", i_r, ORDER),
        _fixed_idx(layout, "q_i_c", m, dev),
        _fixed_idx(layout, "t_i_c", m, dev),
        _fixed_idx(layout, "line_delay", m, dev),
        _fixed_idx(layout, "time_offset", m, dev),
    ]
    if p.n_points > 0:
        parts.append(layout.global_indices("points", p.obs_pt_id.to(i_s.dtype)))
    return r, J, torch.cat(parts, dim=1)


def _point_prior_eval(params, p: SplineProblem, layout):
    """Gaussian prior on the points block: r = W (pt - prior_mean).

    Returns (r (P,3), J=W (P,3,3), idx (P,3)) or None when inactive.
    """
    if p.n_points == 0 or p.pt_prior_sqrt_info is None:
        return None
    W = p.pt_prior_sqrt_info
    d = params["points"] - p.pt_prior_mean
    r = torch.einsum("pij,pj->pi", W, d)
    idx = layout.global_indices("points", torch.arange(p.n_points, device=W.device))
    return r, W, idx


def _scatter(H, g, r, J, idx, sqrt_w=None):
    """Accumulate J^T J blocks / J^T r into dense normal equations (in place)."""
    if sqrt_w is not None:
        r = r * sqrt_w[:, None]
        J = J * sqrt_w[:, None, None]
    Hb = torch.einsum("mri,mrj->mij", J, J)
    gb = torch.einsum("mri,mr->mi", J, r)
    H.index_put_((idx[:, :, None], idx[:, None, :]), Hb, accumulate=True)
    g.index_put_((idx,), gb, accumulate=True)
    return H, g


def _obs_fields(p: SplineProblem) -> dict:
    """The per-observation tensors actually present in this problem."""
    d = dict(obs_t=p.obs_t, obs_row=p.obs_row, obs_uv=p.obs_uv,
             obs_pt=p.obs_pt, obs_valid=p.obs_valid)
    if p.obs_pt_id is not None:
        d["obs_pt_id"] = p.obs_pt_id
    if p.obs_sqrt_info is not None:
        d["obs_sqrt_info"] = p.obs_sqrt_info
    return d


def make_solver_functions(p: SplineProblem, layout, reproj_chunk: int | None = None,
                          include_prior: bool = True):
    """(linearize_fn, cost_fn) by direct block scatter-add (the reference
    path the fast linearizer is held against).

    ``reproj_chunk``: if set, reprojection blocks are assembled over
    consecutive chunks of that many observations, bounding peak memory.

    ``include_prior``: sharded callers pass False and add the board-point
    prior once, after the reduction over shards.
    """

    def cost_fn(params):
        ra, _, _ = _accel_r_and_idx(params, p, layout, with_jac=False)
        rg, _, _ = _gyro_r_and_idx(params, p, layout, with_jac=False)
        rp, _, _ = _reproj_r_and_idx(params, p, layout, with_jac=False)
        c = 0.5 * torch.sum(ra * ra) + 0.5 * torch.sum(rg * rg)
        c = c + robust.huber_cost(rp.reshape(-1), HUBER_PX, group_size=2)
        prior = _point_prior_eval(params, p, layout) if include_prior else None
        if prior is not None:
            c = c + 0.5 * torch.sum(prior[0] ** 2)
        return c

    def linearize_fn(params):
        D = layout.tangent_dim
        dtype, dev = p.obs_uv.dtype, p.obs_uv.device
        H = torch.zeros((D, D), dtype=dtype, device=dev)
        g = torch.zeros((D,), dtype=dtype, device=dev)
        ra, Ja, ia = _accel_r_and_idx(params, p, layout, with_jac=True)
        _scatter(H, g, ra, Ja, ia)
        rg, Jg, ig = _gyro_r_and_idx(params, p, layout, with_jac=True)
        _scatter(H, g, rg, Jg, ig)
        cost = 0.5 * torch.sum(ra * ra) + 0.5 * torch.sum(rg * rg)
        prior = _point_prior_eval(params, p, layout) if include_prior else None
        if prior is not None:
            rq, Wq, iq = prior
            _scatter(H, g, rq, Wq, iq)
            cost = cost + 0.5 * torch.sum(rq * rq)

        mo = p.obs_t.shape[0]
        step = reproj_chunk or mo
        for s in range(0, mo, step):
            pc = p._replace(**{k: v[s:s + step] for k, v in _obs_fields(p).items()})
            rp, Jp, ip = _reproj_r_and_idx(params, pc, layout, with_jac=True)
            hw = robust.huber_sqrt_weights(rp.reshape(-1), HUBER_PX, group_size=2)
            hw = hw.reshape(rp.shape)[:, 0]
            _scatter(H, g, rp, Jp, ip, sqrt_w=hw)
            cost = cost + robust.huber_cost(rp.reshape(-1), HUBER_PX, group_size=2)
        return H, g, cost

    return linearize_fn, cost_fn


# ---------------------------------------------------------------------------
# Chunk-local dense assembly (the fast path)
#
# Measurements are time-sorted, so a contiguous chunk only touches a LOCAL
# window of knots. Per chunk the fused densify + Gram kernel builds the
# chunk-local normal equations H_l = D^T D (L x L) from the compact
# Jacobian, and one index_add_ over a host-planned flat index adds every
# chunk's block into the global H.
# ---------------------------------------------------------------------------

class ChunkPlan(NamedTuple):
    """Per-chunk window geometry for one measurement family (host arrays)."""

    n_chunks: int
    chunk: int
    w_s: int  # so3 knots covered by any chunk (incl. margin)
    w_r: int  # r3 knots (0 if unused)
    s_base: np.ndarray  # (K,) first so3 knot per chunk
    r_base: np.ndarray  # (K,)


def _plan_chunks(times: np.ndarray, p: SplineProblem, chunk: int,
                 use_r3: bool, margin: int = 2) -> ChunkPlan:
    """Host-side: compute per-chunk knot windows from concrete times."""
    t = np.asarray(times)
    m = t.shape[0]
    k = max(1, (m + chunk - 1) // chunk)
    i_s = np.clip(np.floor((t - p.t0) / p.dt_so3), 0, p.n_so3 - ORDER).astype(np.int64)
    i_r = np.clip(np.floor((t - p.t0) / p.dt_r3), 0, p.n_r3 - ORDER).astype(np.int64)
    s_base, r_base, spans_s, spans_r = [], [], [], []
    for c in range(k):
        sl = slice(c * chunk, min((c + 1) * chunk, m))
        cs = i_s[sl]
        cr = i_r[sl]
        s_base.append(max(int(cs.min()) - margin, 0))
        r_base.append(max(int(cr.min()) - margin, 0))
        spans_s.append(int(cs.max()) - s_base[-1] + ORDER + margin)
        spans_r.append(int(cr.max()) - r_base[-1] + ORDER + margin)
    w_s = min(max(spans_s), p.n_so3)
    w_r = min(max(spans_r), p.n_r3) if use_r3 else 0
    s_base = np.minimum(np.asarray(s_base), p.n_so3 - w_s).clip(0)
    r_base = np.minimum(np.asarray(r_base), p.n_r3 - max(w_r, 1)).clip(0)
    return ChunkPlan(n_chunks=k, chunk=chunk, w_s=int(w_s), w_r=int(w_r),
                     s_base=s_base.astype(np.int64), r_base=r_base.astype(np.int64))


def _chunk_arrays(arrs: dict, chunk: int, pad_values: dict):
    """Pad the leading axis to n_chunks*chunk and reshape to (K, chunk, ...)."""
    m = next(iter(arrs.values())).shape[0]
    k = max(1, (m + chunk - 1) // chunk)
    pad = k * chunk - m
    out = {}
    for name, x in arrs.items():
        fill = torch.full((pad,) + tuple(x.shape[1:]), pad_values.get(name, 0),
                          dtype=x.dtype, device=x.device)
        out[name] = torch.cat([x, fill]).reshape((k, chunk) + tuple(x.shape[1:]))
    return out


def plan_fast_assembly(p: SplineProblem, obs_chunk: int = 2048, imu_chunk: int = 256):
    """Host-side planning for the chunk-local assembly: (plans, arrs).

    plans = (obs_plan, acc_plan, gyr_plan); arrs = dict of chunked
    (K, chunk, ...) measurement tensors.
    """
    obs_plan = _plan_chunks(p.obs_t.cpu().numpy(), p, obs_chunk, use_r3=True)
    acc_plan = _plan_chunks(p.accel_t.cpu().numpy(), p, imu_chunk, use_r3=True)
    gyr_plan = _plan_chunks(p.gyro_t.cpu().numpy(), p, imu_chunk, use_r3=False)

    arrs = {}
    arrs.update(_chunk_arrays(_obs_fields(p), obs_plan.chunk, {"obs_valid": False}))
    arrs.update(_chunk_arrays(
        dict(accel_t=p.accel_t, accel_meas=p.accel_meas, accel_valid=p.accel_valid),
        acc_plan.chunk, {"accel_valid": False}))
    arrs.update(_chunk_arrays(
        dict(gyro_t=p.gyro_t, gyro_meas=p.gyro_meas, gyro_valid=p.gyro_valid),
        gyr_plan.chunk, {"gyro_valid": False}))
    return (obs_plan, acc_plan, gyr_plan), arrs


def plan_bases(plans) -> dict:
    obs_plan, acc_plan, gyr_plan = plans
    return dict(obs_s=obs_plan.s_base, obs_r=obs_plan.r_base,
                acc_s=acc_plan.s_base, acc_r=acc_plan.r_base,
                gyr_s=gyr_plan.s_base)


def _region_idx(starts_list) -> np.ndarray:
    """(K, L) global tangent index per chunk-local coordinate.

    starts_list: layout-ordered [(region_start (K,) or scalar, width)]."""
    parts = [np.asarray(start, np.int64).reshape(-1, 1) + np.arange(width)
             for start, width in starts_list]
    K = max(pt.shape[0] for pt in parts)
    return np.concatenate([np.broadcast_to(pt, (K, pt.shape[1])) for pt in parts], axis=1)


# SplineProblem scalar fields a linearizer or cost accepts per problem
# through its ``bases`` dict (the multi-sequence batch: per-sequence time
# origins, SEW weights, bias-knot spacing and valid-time bound; dt_bias only
# scales the bias-spline coordinate, never a derivative, since bias splines
# are evaluated at order 0).
PROBLEM_OVERRIDE_KEYS = ("t0", "w_accel", "w_gyro", "dt_bias", "t_hi")

# Chunk-base keys of ``bases`` (plan_bases) and the measurement fields of the
# two IMU families.
_BASE_KEYS = ("obs_s", "obs_r", "acc_s", "acc_r", "gyr_s")
_ACC_KEYS = ("accel_t", "accel_meas", "accel_valid")
_GYR_KEYS = ("gyro_t", "gyro_meas", "gyro_valid")


class _Family(NamedTuple):
    """Static assembly data of one measurement family for one set of bases
    and N stacked problems."""

    segments: tuple  # kernel-form segments (solver/gram.py)
    L: int
    g_idx: torch.Tensor  # (N, K, L) flat row of (N, D) g per chunk-local coordinate
    h_idx: torch.Tensor  # (N, K, L*L) flat entry of (N, D, D) H per local entry


def _family(segments, starts_list, D: int, n_seq: int, device) -> _Family:
    idx = _region_idx(starts_list)
    K, L = idx.shape
    seq = np.arange(n_seq, dtype=np.int64)[:, None, None]
    g_idx = idx[None] + seq * D
    h_idx = (idx[:, :, None] * D + idx[:, None, :]).reshape(1, K, L * L) + seq * (D * D)
    return _Family(tuple(segments), int(L), torch.as_tensor(g_idx, device=device),
                   torch.as_tensor(h_idx, device=device))


def _kernel_segments(runs_and_fixed):
    """[("run", col0, nblk, td, wblk) | ("fixed", col0, ncols)] -> kernel
    form with out_off, plus the total width L."""
    out, off = [], 0
    for seg in runs_and_fixed:
        if seg[0] == "run":
            _, col0, nblk, td, wblk = seg
            out.append(("run", col0, nblk, td, wblk, off))
            off += wblk * td
        else:
            _, col0, ncols = seg
            out.append(("fixed", col0, ncols, off))
            off += ncols
    return tuple(out), off


def gram_layouts(p: SplineProblem, plans) -> dict:
    """Per family, the fused Gram's input layout:
    ``{name: (rows per measurement, compact width F, kernel segments, L)}``.

    The compact Jacobian columns follow each residual's local tangent
    (``*_residual_local``); the chunk-local regions follow the global
    layout's block order (``build_layout``).
    """
    obs_plan, acc_plan, gyr_plan = plans
    obs = [("run", 0, ORDER, 3, obs_plan.w_s), ("run", 18, ORDER, 3, obs_plan.w_r),
           ("fixed", 36, 8)]
    if p.n_points > 0:
        obs.append(("run", 44, 1, 3, p.n_points))
    acc = [("run", 0, ORDER, 3, acc_plan.w_s), ("run", 18, ORDER, 3, acc_plan.w_r),
           ("run", 36, BIAS_ORDER, 3, p.n_bias), ("fixed", 45, 9)]
    gyr = [("run", 0, ORDER, 3, gyr_plan.w_s), ("run", 18, BIAS_ORDER, 3, p.n_bias),
           ("fixed", 27, 9)]
    return {"obs": (2, 47 if p.n_points > 0 else 44, *_kernel_segments(obs)),
            "accel": (3, 54, *_kernel_segments(acc)),
            "gyro": (3, 36, *_kernel_segments(gyr))}


def _gram_cast(J, r, idx, segments, L, gram_dtype):
    """The plain densify + Gram with H's operands cast to ``gram_dtype`` and
    accumulated in the input dtype; g stays in full precision."""
    D, rf = gram._densify_segments(r[:, :, None], J[:, :, None, :],
                                   gram._per_row_segments(segments, idx), L)
    Dc = D.to(gram_dtype).to(D.dtype)
    return (torch.einsum("krl,krm->klm", Dc, Dc), torch.einsum("krl,kr->kl", D, rf))


def make_fast_linearizer(p: SplineProblem, layout, plans, include_prior: bool = True,
                         sequential: bool = False, gram_dtype=None, *, n_seq: int | None = None):
    """Chunk-local linearizer: ``lin(params, arrs, bases=None) -> (H, g, cost)``.

    ``plans`` and ``arrs`` (the chunked-tensor dict) come from
    :func:`plan_fast_assembly`. ``bases`` holds the per-chunk first-knot
    indices (host arrays; :func:`plan_bases` of ``plans`` by default) and
    may also carry

    * ``s_org`` / ``r_org`` — the knot-window origin of the target H: 0 for
      the global layout, the shard's first knot for the knot-sharded local
      layouts of ``parallel/schur.py`` (``layout`` is then the local one);
    * the per-problem scalars of :data:`PROBLEM_OVERRIDE_KEYS`.

    Each family's chunks are evaluated together (one batch over all
    chunks), densified and contracted by ``gram.fused_gram`` with the
    layouts of :func:`gram_layouts` (three launches per linearize on the
    card: reprojection, accelerometer, gyroscope), and added into H by one
    ``index_add_`` each, over a flat index built once on the host per
    distinct set of bases and kept.

    ``sequential``: evaluate and contract one chunk at a time, which bounds
    the peak memory to one chunk's buffers (the JAX package's ``lax.scan``
    mode); on the card that is one kernel launch per chunk and family.

    ``gram_dtype`` (e.g. ``torch.bfloat16``) casts the Gram operands of H
    on the plain path (CPU tensors) and accumulates in the problem dtype,
    as the JAX package's XLA path does; g and the cost stay in full
    precision. On the card the kernel always computes in float32, as the
    JAX package's ``gram_kernel="pallas"`` path does.

    ``include_prior``: sharded callers pass False and add the board-point
    prior once, after the reduction over shards.

    ``n_seq=N``: the linearizer of N problems stacked on a leading axis
    (params and arrs leaves (N, ...), the overrides in ``bases`` (N,)
    tensors; the chunk bases are shared, see ``core/batch_estimator.py``).
    It returns ``H (N, D, D)``, ``g (N, D)``, ``cost (N,)``: residuals and
    Jacobians of all N come from one ``torch.func.vmap`` over the sequence
    axis, the N*K chunks of a family go through one kernel launch, and one
    ``index_add_`` per family places every block at its sequence's offset.

    On the card ``index_add_`` sums overlapping chunk blocks with atomics,
    in an order that varies from run to run: H and g then differ between
    runs by float32 rounding of those few-term sums (relative ~1e-7 of
    the entry), which is far below what the damped solve resolves.
    """
    obs_plan, acc_plan, gyr_plan = plans
    nb3 = 3 * p.n_bias
    np3 = 3 * p.n_points  # points are chunk-global: every chunk sees all P
    off = layout.offsets
    D = layout.tangent_dim
    dev = p.obs_uv.device
    N = 1 if n_seq is None else int(n_seq)
    glayouts = gram_layouts(p, plans)
    w_of = {"obs_s": obs_plan.w_s, "obs_r": obs_plan.w_r, "acc_s": acc_plan.w_s,
            "acc_r": acc_plan.w_r, "gyr_s": gyr_plan.w_s}
    tables = {}

    def _tables(bases):
        """(families, per-chunk base tensors) for these bases, built on the
        host once and kept."""
        b = {k: np.asarray(bases[k], np.int64).reshape(-1) for k in _BASE_KEYS}
        s_org, r_org = int(bases.get("s_org", 0)), int(bases.get("r_org", 0))
        key = tuple(b[k].tobytes() for k in _BASE_KEYS) + (s_org, r_org)
        if key in tables:
            return tables[key]
        # Global start and width of each chunk-local region, in segment order.
        starts = {"obs": [(3 * (b["obs_s"] - s_org), 3 * obs_plan.w_s),
                          (off["t_r3"] + 3 * (b["obs_r"] - r_org), 3 * obs_plan.w_r),
                          (off["q_i_c"], 8)] + ([(off["points"], np3)] if p.n_points > 0
                                                else []),
                  # bias_a | gravity | accl_intr: contiguous by layout contract.
                  "accel": [(3 * (b["acc_s"] - s_org), 3 * acc_plan.w_s),
                            (off["t_r3"] + 3 * (b["acc_r"] - r_org), 3 * acc_plan.w_r),
                            (off["bias_a"], nb3 + 9)],
                  # bias_g | gyro_intr: contiguous by layout contract.
                  "gyro": [(3 * (b["gyr_s"] - s_org), 3 * gyr_plan.w_s),
                           (off["bias_g"], nb3 + 9)]}
        fams = {}
        for name, (_, _, ksegs, L) in glayouts.items():
            fams[name] = _family(ksegs, starts[name], D, N, dev)
            assert fams[name].L == L, (name, fams[name].L, L)
        dbases = {k: torch.as_tensor(v, device=dev).reshape(-1, 1) for k, v in b.items()}
        if sequential:  # one contiguous index per chunk
            fams = {name: fam._replace(
                g_idx=[fam.g_idx[:, k].reshape(-1) for k in range(fam.g_idx.shape[1])],
                h_idx=[fam.h_idx[:, k].reshape(-1) for k in range(fam.h_idx.shape[1])])
                for name, fam in fams.items()}
        tables[key] = (fams, dbases)
        return tables[key]

    def _flat(arrs, keys):
        """(Kc, chunk, ...) chunked fields -> (Kc*chunk, ...) problem fields."""
        return {k: arrs[k].reshape((-1,) + tuple(arrs[k].shape[2:])) for k in keys}

    obs_keys = tuple(_obs_fields(p).keys())

    def _eval(name, params, arrs, pov):
        """One problem's (r, J, knot indices, cost) of family ``name`` over
        the chunks in ``arrs``; reprojection rows carry their Huber weight."""
        if name == "accel":
            r, J, idx = _accel_eval(params, p._replace(**_flat(arrs, _ACC_KEYS), **pov), True)
            return r, J, idx, 0.5 * torch.sum(r * r)
        if name == "gyro":
            r, J, idx = _gyro_eval(params, p._replace(**_flat(arrs, _GYR_KEYS), **pov), True)
            return r, J, idx, 0.5 * torch.sum(r * r)
        po = p._replace(**_flat(arrs, obs_keys), **pov)
        r, J, idx = _reproj_eval(params, po, with_jac=True)
        c = robust.huber_cost(r.reshape(-1), HUBER_PX, group_size=2)
        hw = robust.huber_sqrt_weights(r.reshape(-1), HUBER_PX, group_size=2)
        hw = hw.reshape(r.shape)[:, 0]
        if p.n_points > 0:
            idx = idx + (po.obs_pt_id,)
        return r * hw[:, None], J * hw[:, None, None], idx, c

    # Per family: its field keys, and per run segment the chunk-base key
    # and window width that make the block index chunk-local (None: the
    # index is already the region's own, as for biases and points).
    fam_spec = {"accel": (_ACC_KEYS, ("acc_s", "acc_r", None)),
                "gyro": (_GYR_KEYS, ("gyr_s", None)),
                "obs": (obs_keys, ("obs_s", "obs_r", None))}

    def _eval_all(name, params, sub, pov):
        """_eval for every problem: outputs with a leading problem axis."""
        if n_seq:
            return vmap(lambda prm, ar, pv: _eval(name, prm, ar, pv))(params, sub, pov)
        r, J, idx, c = _eval(name, params, sub, pov)
        return r[None], J[None], tuple(i[None] for i in idx), c[None]

    def _family_step(name, fam, params, arrs, pov, dbases, chunks, h_idx, g_idx, H, g):
        """Evaluate family ``name`` on the chunks ``chunks`` (a slice) of
        every problem, contract all of them in one kernel launch and add
        them into (H, g); returns the per-problem cost (N,)."""
        keys, run_bases = fam_spec[name]
        sub = {k: arrs[k][:, chunks] if n_seq else arrs[k][chunks] for k in keys}
        Kc = sub[keys[0]].shape[1 if n_seq else 0]
        r, J, idx, cost = _eval_all(name, params, sub, pov)
        Nn, M, rd, F = J.shape
        C, R = M // Kc, (M // Kc) * rd
        runs = []
        for i, bk in zip(idx, run_bases):
            if bk is not None:  # chunk-local block index of each measurement's first knot
                i = torch.clamp(i.reshape(Nn, Kc, C) - dbases[bk][chunks], 0, w_of[bk] - ORDER)
            runs.append(i.reshape(Nn * Kc, C).repeat_interleave(rd, dim=1))
        Jk, rk, ridx = J.reshape(Nn * Kc, R, F), r.reshape(Nn * Kc, R), torch.stack(runs)
        if Jk.device.type == "cuda":
            Jk, rk, ridx = Jk.float(), rk.float(), ridx.to(torch.int32)
        if gram_dtype is not None and Jk.device.type == "cpu":
            Hl, gl = _gram_cast(Jk, rk, ridx, fam.segments, fam.L, gram_dtype)
        else:
            Hl, gl = gram.fused_gram(Jk.contiguous(), rk.contiguous(), ridx.contiguous(),
                                     fam.segments, fam.L, tag=name)
        H.view(-1).index_add_(0, h_idx, Hl.reshape(-1).to(H.dtype))
        g.view(-1).index_add_(0, g_idx, gl.reshape(-1).to(g.dtype))
        return cost

    n_chunks = {"accel": acc_plan.n_chunks, "gyro": gyr_plan.n_chunks,
                "obs": obs_plan.n_chunks}

    def linearize(params, arrs, bases=None):
        fams, dbases = _tables(plan_bases(plans) if bases is None else bases)
        pov = {k: bases[k] for k in PROBLEM_OVERRIDE_KEYS if bases is not None and k in bases}
        dtype = p.obs_uv.dtype
        H = torch.zeros((N, D, D), dtype=dtype, device=dev)
        g = torch.zeros((N, D), dtype=dtype, device=dev)
        cost = torch.zeros((N,), dtype=dtype, device=dev)
        for name in ("accel", "gyro", "obs"):
            fam = fams[name]
            if sequential:
                for k in range(n_chunks[name]):
                    cost = cost + _family_step(name, fam, params, arrs, pov, dbases,
                                               slice(k, k + 1), fam.h_idx[k], fam.g_idx[k],
                                               H, g)
            else:
                cost = cost + _family_step(name, fam, params, arrs, pov, dbases, slice(None),
                                           fam.h_idx.reshape(-1), fam.g_idx.reshape(-1), H, g)
        prior = _point_prior_eval(params, p, layout) if include_prior else None
        if prior is not None:
            if n_seq:
                raise ValueError("board points are not supported for stacked problems")
            rq, Wq, iq = prior
            _scatter(H[0], g[0], rq, Wq, iq)
            cost = cost + 0.5 * torch.sum(rq * rq)
        if n_seq:
            return H, g, cost
        return H[0], g[0], cost[0]

    return linearize


def make_solver_functions_fast(p: SplineProblem, layout, obs_chunk: int = 4096,
                               imu_chunk: int = 256, gram_dtype=None):
    """(linearize_fn, cost_fn) using chunk-local dense assembly (see above).

    Produces the same (H, g, cost) as :func:`make_solver_functions`. The
    chunk sizes are the JAX package's, swept on a TPU; they are parameters
    here until an H100 sweep sets them.
    """
    plans, arrs = plan_fast_assembly(p, obs_chunk, imu_chunk)
    lin = make_fast_linearizer(p, layout, plans, gram_dtype=gram_dtype)
    bases = plan_bases(plans)

    def linearize_fn(params):
        return lin(params, arrs, bases)

    def cost_fn(params):
        ra, _, _ = _accel_eval(params, p, with_jac=False)
        rg, _, _ = _gyro_eval(params, p, with_jac=False)
        rp, _, _ = _reproj_eval(params, p, with_jac=False)
        c = 0.5 * torch.sum(ra * ra) + 0.5 * torch.sum(rg * rg)
        c = c + robust.huber_cost(rp.reshape(-1), HUBER_PX, group_size=2)
        prior = _point_prior_eval(params, p, layout)
        if prior is not None:
            c = c + 0.5 * torch.sum(prior[0] ** 2)
        return c

    return linearize_fn, cost_fn


# ---------------------------------------------------------------------------
# Problem construction + initialization
# ---------------------------------------------------------------------------

def _num_knots(duration: float, dt: float, order: int) -> int:
    return int(np.ceil(duration / dt)) + order - 1


def init_spline_params(poses: PoseDataset, q_i_c0, t_i_c0, p: SplineProblem,
                       imu: ImuData, pose_time_offset: float = 0.0,
                       dtype=None, device=None):
    """Initialize knots from camera poses and gravity from early
    accelerometer samples. ``pose_time_offset`` shifts the pose timestamps
    onto the IMU clock."""
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    t0, dt_so3, dt_r3 = p.t0, p.dt_so3, p.dt_r3
    n_so3, n_r3, n_bias = p.n_so3, p.n_r3, p.n_bias

    def T(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    ok = poses.valid
    tv = poses.times[ok] + pose_time_offset
    q_wc = T(poses.q_w_c[ok])
    t_wc = T(poses.t_w_c[ok])
    # T_w_i = T_w_c * T_i_c^{-1}
    q_ci, t_ci = lie.se3_inverse(T(q_i_c0), T(t_i_c0))
    q_wi, t_wi = lie.se3_compose(q_wc, t_wc, q_ci.expand_as(q_wc), t_ci.expand_as(t_wc))
    # Fix quaternion hemisphere continuity before slerp resampling.
    qn = q_wi.cpu().numpy().copy()
    for k in range(1, qn.shape[0]):
        if np.dot(qn[k], qn[k - 1]) < 0:
            qn[k] = -qn[k]
    q_wi = T(qn)
    tvj = T(tv)
    ar = lambda n: torch.arange(n, dtype=dtype, device=device)  # noqa: E731
    knot_t_so3 = t0 + ar(n_so3) * dt_so3 - (ORDER - 1) * dt_so3 / 2.0
    knot_t_r3 = t0 + ar(n_r3) * dt_r3 - (ORDER - 1) * dt_r3 / 2.0
    q_knots = interpolation.interp_quaternion(tvj, q_wi, knot_t_so3)
    t_knots = interpolation.interp_vector(tvj, t_wi, knot_t_r3)

    # Gravity: average R_w_i(t) * accel over samples near the first poses.
    sel = (imu.times >= tv[0]) & (imu.times <= tv[0] + 1.0)
    acc = T(imu.accel[sel])
    q_at = interpolation.interp_quaternion(tvj, q_wi, T(imu.times[sel]))
    g_est = torch.mean(lie.quat_rotate(q_at, acc), dim=0)
    g_est = 9.81 * g_est / torch.clamp(torch.linalg.vector_norm(g_est), min=1e-9)

    out = {
        "q_so3": q_knots,
        "t_r3": t_knots,
        "bias_a": torch.zeros((n_bias, 3), dtype=dtype, device=device),
        "bias_g": torch.zeros((n_bias, 3), dtype=dtype, device=device),
        "gravity": g_est,
        "q_i_c": T(q_i_c0),
        "t_i_c": T(t_i_c0),
        "line_delay": torch.zeros((1,), dtype=dtype, device=device),
        "time_offset": torch.zeros((1,), dtype=dtype, device=device),
        "accl_intr": identity_accl_intr(dtype, device),
        "gyro_intr": identity_gyro_intr(dtype, device),
    }
    if p.n_points > 0:
        out["points"] = p.pt_prior_mean.to(dtype)
    return out


def build_problem(corners: CornerDataset, calib: CameraCalibration,
                  imu: ImuData, sew: SplineWeightingData,
                  time_offset: float, rolling_shutter: bool,
                  dtype=None, device=None) -> SplineProblem:
    """Assemble measurement batches. Corner times are shifted by
    ``time_offset`` onto the IMU clock (t_imu = t_cam + offset)."""
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    cam_t = corners.times + time_offset
    t_lo = max(float(imu.times[0]), float(cam_t.min()))
    t_hi = min(float(imu.times[-1]), float(cam_t.max()))
    duration = t_hi - t_lo
    n_so3 = _num_knots(duration, sew.dt_so3, ORDER)
    n_r3 = _num_knots(duration, sew.dt_r3, ORDER)
    dt_bias = min(10.0, duration)
    n_bias = _num_knots(duration, dt_bias, BIAS_ORDER)

    V, P = corners.points2d.shape[:2]
    obs_t = np.repeat(cam_t, P)
    obs_row = corners.points2d[..., 1].reshape(-1)
    obs_uv = corners.points2d.reshape(-1, 2)
    obs_pt = np.tile(corners.board_points, (V, 1))
    obs_valid = corners.valid.reshape(-1)

    def T(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    n_imu = imu.times.shape[0]
    return SplineProblem(
        t0=t_lo, dt_so3=sew.dt_so3, dt_r3=sew.dt_r3, dt_bias=dt_bias,
        n_so3=n_so3, n_r3=n_r3, n_bias=n_bias,
        accel_t=T(imu.times), accel_meas=T(imu.accel),
        accel_valid=torch.ones(n_imu, dtype=torch.bool, device=device), w_accel=1.0 / sew.std_r3,
        gyro_t=T(imu.times), gyro_meas=T(imu.gyro),
        gyro_valid=torch.ones(n_imu, dtype=torch.bool, device=device), w_gyro=1.0 / sew.std_so3,
        obs_t=T(obs_t), obs_row=T(obs_row), obs_uv=T(obs_uv), obs_pt=T(obs_pt),
        obs_valid=T(obs_valid, torch.bool),
        cam_params=T(calib.params), model_name=calib.model_name,
        rolling_shutter=rolling_shutter)


def enable_board_points(p: SplineProblem, *, point_prior_std: float = 1e-3,
                        point_cov: np.ndarray | None = None,
                        reproj_cov: np.ndarray | None = None,
                        board_points: np.ndarray | None = None,
                        obs_pt_id: np.ndarray | None = None) -> SplineProblem:
    """Activate the POINTS parameter block on an assembled problem.

    Board points become parameters, reprojection residuals are whitened by
    the per-feature covariance, and a Gaussian prior pins each point (and
    the world gauge that freeing the board would open).

    ``point_cov``  — (P, 3, 3) prior covariance per point; default
                     isotropic ``point_prior_std``² I.
    ``reproj_cov`` — (P, 2, 2) per-point feature covariance in px².
    ``board_points``/``obs_pt_id`` — the (P, 3) board geometry and the
    (Mo,) observation -> point index; inferred from the view-major tiling
    of :func:`build_problem` when omitted.
    """
    mo = int(p.obs_t.shape[0])
    device = p.obs_uv.device
    bp0 = p.obs_pt.cpu().numpy()
    if board_points is not None and obs_pt_id is not None:
        pts = np.asarray(board_points)
        P = int(pts.shape[0])
        ids = np.asarray(obs_pt_id, np.int64)
        if ids.shape[0] != mo:
            raise ValueError(f"obs_pt_id has {ids.shape[0]} entries for "
                             f"{mo} observations")
        if ids.min() < 0 or ids.max() >= P:
            raise ValueError("obs_pt_id indexes outside the board")
    elif board_points is not None or obs_pt_id is not None:
        raise ValueError("pass board_points and obs_pt_id together")
    else:
        P = None
        for cand in range(1, mo + 1):
            if mo % cand == 0 and np.array_equal(bp0[:cand], bp0[cand:2 * cand]) \
                    and np.allclose(bp0, np.tile(bp0[:cand], (mo // cand, 1))):
                P = cand
                break
        if P is None:
            raise ValueError(
                "observations are not a per-view tiling of one board; pass "
                "board_points and obs_pt_id explicitly")
        pts = bp0[:P]
        ids = np.tile(np.arange(P, dtype=np.int64), mo // P)

    dtype = p.obs_uv.dtype

    def _sqrt_info(cov, floor):
        # W = inv(chol(cov))^T so that W^T W = cov^{-1}; a variance floor
        # keeps near-singular empirical covariances factorizable.
        cov = np.asarray(cov, np.float64)
        cov = cov + floor * np.eye(cov.shape[-1])
        Lc = np.linalg.cholesky(cov)
        return np.transpose(np.linalg.inv(Lc), (0, 2, 1))

    if point_cov is None:
        W = np.broadcast_to(np.eye(3) / point_prior_std, (P, 3, 3)).copy()
    else:
        W = _sqrt_info(point_cov, 1e-10)  # 10 um std floor
    sqrt_info = None
    if reproj_cov is not None:
        Sr = _sqrt_info(reproj_cov, 1e-4)  # 0.01 px std floor, (P, 2, 2)
        sqrt_info = torch.as_tensor(Sr[ids], dtype=dtype, device=device)

    return p._replace(n_points=P, obs_pt_id=torch.as_tensor(ids, device=device),
                      obs_sqrt_info=sqrt_info,
                      pt_prior_mean=torch.as_tensor(pts, dtype=dtype, device=device),
                      pt_prior_sqrt_info=torch.as_tensor(W, dtype=dtype, device=device))


# Tangent dimension from which "auto" takes the banded solve
# (solver/banded.py): the crossover of scripts/sweep_torch_banded.py on an
# NVIDIA H100 80GB HBM3 at 700.00 W (float32, lambda 1e-4, best of 5,
# CUDA events; PERF.md, PR 6), dense lm._solve_damped against banded ms:
#   D =  5,723:   6.7 vs  38.1     D = 22,700: 129.9 vs 143.2
#   D = 11,381:  24.5 vs  88.5     D = 28,358: 228.5 vs 195.6
#   D = 17,039:  63.9 vs 124.4     D = 34,016: 372.5 vs 244.6
# The dense Cholesky grows ~D^2.5 here; the banded solve is a host loop of
# small launches over slabs, ~linear in D. An earlier run of the same
# script put 28,358 at a tie (226.8 vs 227.1 ms): re-sweep when either
# solve changes.
BANDED_MIN_DIM = 24324


def make_solve_fn(p: SplineProblem, layout, solver: str = "auto",
                  banded_min_dim: int = BANDED_MIN_DIM):
    """Damped-solve callable for lm.lm_optimize; None selects the dense
    Jacobi-equilibrated Cholesky of ``solver/lm.py``.

    "banded" (or "auto" at ``D >= banded_min_dim``):
    block-tridiagonal-over-slabs + arrowhead Schur
    solve (solver/banded.py) when the problem's measurement windows admit
    a slab decomposition. Returns None (the dense solve) for "dense", for
    "auto" below ``banded_min_dim``, and for "auto" when no decomposition
    exists; "banded" without one raises ValueError.
    """
    if solver == "dense" or (solver == "auto" and layout.tangent_dim < banded_min_dim):
        return None
    if solver in ("auto", "banded"):
        from openimucameracalibrator_torch.solver import banded as banded_mod

        struct = banded_mod.from_problem(layout, p, ORDER)
        if struct is not None:
            return banded_mod.make_banded_solver(struct)
        if solver == "banded":
            raise ValueError("problem admits no slab decomposition; use "
                             "solver='auto' or 'dense'")
        return None
    raise ValueError(f"unknown solver {solver!r}")


def optimize(p: SplineProblem, params0: dict, flags: frozenset = DEFAULT_FLAGS,
             max_iters: int = 50, config: lm.LMConfig | None = None,
             reproj_chunk: int | None = None, method: str = "fast",
             solver: str = "auto", strategy: str = "classic") -> lm.LMResult:
    """Run LM on the full problem with the given free-parameter flags.

    method "fast" uses chunk-local dense assembly; "scatter" the direct
    block scatter-add.
    """
    cfg = config or lm.LMConfig(max_iters=max_iters, ftol=1e-4)
    return optimize_stages(p, params0, [(flags, cfg.max_iters)], config=cfg,
                           method=method, reproj_chunk=reproj_chunk,
                           solver=solver, strategy=strategy)[-1]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def optimize_stages(p: SplineProblem, params0: dict, stages,
                    config: lm.LMConfig | None = None, method: str = "fast",
                    reproj_chunk: int | None = None,
                    checkpoint_dir: str | None = None,
                    solver: str = "auto", strategy: str = "classic",
                    obs_chunk: int = 4096, imu_chunk: int = 256) -> list:
    """Run a SCHEDULE of LM stages; ``stages`` is a list of (flags, max_iters).

    Returns one LMResult per stage; each stage starts from the previous
    solution. ``checkpoint_dir`` snapshots each completed stage; on rerun
    completed stages are restored (with their true convergence status) when
    the fingerprint of problem, schedule, parameters and solver settings
    matches, and re-solved otherwise. ``solver`` chooses the damped solve
    (:func:`make_solve_fn`).
    """
    from openimucameracalibrator_torch.utils import checkpoint as ckpt

    layout = build_layout(p)
    if method == "fast":
        lin, cost = make_solver_functions_fast(p, layout, obs_chunk, imu_chunk)
    else:
        lin, cost = make_solver_functions(p, layout, reproj_chunk=reproj_chunk)
    solve_fn = make_solve_fn(p, layout, solver)
    base_cfg = config or lm.LMConfig(ftol=1e-4)
    pdtype = next(iter(params0.values())).dtype
    device = p.obs_uv.device

    if checkpoint_dir:
        host0 = {k: _host(v) for k, v in params0.items()}
        prob_fp = ckpt.fingerprint(
            {k: _host(v) for k, v in p._asdict().items()},
            [(sorted(f), int(n)) for f, n in stages],
            ckpt.tree_signature(host0), str(pdtype),
            sorted(base_cfg._asdict().items()), str(solver), str(strategy))
    else:
        prob_fp = None

    results = []
    params = params0
    for i, (flags, iters) in enumerate(stages):
        restored = (ckpt.load_stage(checkpoint_dir, i, fingerprint=prob_fp)
                    if checkpoint_dir else None)
        if restored is not None:
            saved, meta = restored
            params = {k: torch.as_tensor(v, dtype=pdtype, device=device)
                      for k, v in saved.items()}
            status = int(meta.get("status", lm.STATUS_CONVERGED))
            results.append(lm.LMResult(
                params=params,
                cost=torch.as_tensor(float(meta.get("cost", np.nan)), dtype=pdtype),
                iterations=int(meta.get("iterations", 0)),
                lam=torch.as_tensor(float(meta.get("lam", 0.0)), dtype=pdtype),
                converged=bool(meta.get("converged", status == lm.STATUS_CONVERGED)),
                status=status,
                cost_history=torch.zeros((base_cfg.history_len,), dtype=pdtype)))
            continue
        mask = layout.free_mask(fixed=flags_to_fixed(frozenset(flags)),
                                dtype=pdtype, device=device)
        cfg = base_cfg._replace(max_iters=int(iters))
        res = lm.lm_optimize(lin, cost, layout.retract, params, mask, cfg,
                             solve_fn=solve_fn, strategy=strategy)
        params = res.params
        results.append(res)
        if checkpoint_dir:
            ckpt.save_stage(checkpoint_dir, i, {k: _host(v) for k, v in params.items()},
                            cost=float(res.cost), lam=float(res.lam),
                            iterations=res.iterations, converged=res.converged,
                            status=res.status, fingerprint=prob_fp)
    return results


# ---------------------------------------------------------------------------
# Evaluation helpers
# ---------------------------------------------------------------------------

def evaluate_pose(p: SplineProblem, params, t):
    qs = spline.so3_eval_batch(params["q_so3"], t, p.t0, p.dt_so3, ORDER)
    ts = spline.r3_eval_batch(params["t_r3"], t, p.t0, p.dt_r3, 0, ORDER)
    return qs, ts


def evaluate_imu_components(p: SplineProblem, params, t):
    """(accel_spline, gyro_spline, accel_bias, gyro_bias) at times t; the
    spline terms exclude the bias."""
    qs, omega = spline.so3_vel_batch(params["q_so3"], t, p.t0, p.dt_so3, ORDER)
    a_w = spline.r3_eval_batch(params["t_r3"], t, p.t0, p.dt_r3, 2, ORDER)
    i_b, u_b = spline.spline_coords(t, p.t0, p.dt_bias, p.n_bias, BIAS_ORDER)
    bias = vmap(lambda w, u: spline.r3_eval(w, u, p.dt_bias, 0, BIAS_ORDER))
    ba = bias(spline.gather_window(params["bias_a"], i_b, BIAS_ORDER), u_b)
    bg = bias(spline.gather_window(params["bias_g"], i_b, BIAS_ORDER), u_b)
    acc_spline = lie.quat_rotate(lie.quat_conjugate(qs), a_w + params["gravity"])
    return acc_spline, omega, ba, bg


def evaluate_imu(p: SplineProblem, params, t):
    """Predicted (accel_reading, gyro_reading) at times t."""
    acc_spline, omega, ba, bg = evaluate_imu_components(p, params, t)
    return acc_spline + ba, omega + bg


def mean_reprojection_error(p: SplineProblem, params) -> float:
    """Mean pixel reprojection error over valid observations, in raw pixels
    (feature-covariance whitening disabled for this metric)."""
    p = p._replace(obs_sqrt_info=None)
    layout = build_layout(p)
    rp, _, _ = _reproj_r_and_idx(params, p, layout, with_jac=False)
    w = (p.obs_valid & _in_range(p, p.obs_t)).to(rp.dtype)
    err = torch.linalg.vector_norm(rp, dim=-1) * w
    return float(torch.sum(err) / torch.clamp(torch.sum(w), min=1.0))


def per_view_reprojection_rmse(p: SplineProblem, params,
                               points_per_view: int) -> np.ndarray:
    """(V,) per-view RMSE in pixels, NaN for views with no valid
    observation. Observations are view-major; raw pixels."""
    p = p._replace(obs_sqrt_info=None)
    rp, _, _ = _reproj_eval(params, p, with_jac=False)
    w = (p.obs_valid & _in_range(p, p.obs_t)).to(rp.dtype)
    se_px = torch.sum(rp * rp, dim=-1) * w
    V = p.obs_t.shape[0] // points_per_view
    se_v = se_px[:V * points_per_view].reshape(V, points_per_view).sum(1)
    n_v = w[:V * points_per_view].reshape(V, points_per_view).sum(1)
    rmse = torch.sqrt(se_v / torch.clamp(n_v, min=1.0))
    return torch.where(n_v > 0, rmse, torch.full_like(rmse, float("nan"))).cpu().numpy()
