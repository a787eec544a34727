"""Batched pose initialization: homography DLT, Zhang focal init, PnP, RANSAC.

Port of ``ops/pnp.py`` of the JAX package: normalized-DLT and
least-squares homographies, Zhang's closed-form shared focal, pose from a
homography, the division-model lambda search, calibrated DLT PnP and the
fixed-size-batch RANSAC (K random subsets solved at once, best inlier
count wins). Every function takes a ``mask`` beside the points, so padded
per-view corner arrays work, and broadcasts over leading batch dims.

RANSAC samples its subsets by Gumbel top-k on uniforms drawn from an
explicit ``torch.Generator``. The JAX package draws them from
``jax.random``, a stream torch cannot reproduce, so each RANSAC is split
into a public function that draws the ``(K, P)`` uniforms and a private
one that takes them: given the same uniforms both packages pick the same
subsets.
"""

from __future__ import annotations

import math

import torch

from openimucameracalibrator_torch.ops import lie


def _masked_normalization(x: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization stats over masked 2D points: (centroid, scale)."""
    w = mask[..., None]
    n = torch.clamp(torch.sum(mask, -1), min=1.0)[..., None]
    c = torch.sum(x * w, dim=-2) / n
    d = torch.sqrt(torch.sum((x - c[..., None, :]) ** 2, -1) + 1e-12)
    mean_d = torch.sum(d * mask, -1) / n[..., 0]
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-9)
    return c, s


def _tmat(c, s):
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, z, -s * c[..., 0]], -1),
        torch.stack([z, s, -s * c[..., 1]], -1),
        torch.stack([z, z, o], -1)], -2)


def _denormalize(Hn, co, so, ci, si):
    """H = Ti^{-1} Hn To, scaled to ||H||_F = 1 with H[2,2] >= 0."""
    # Ti is triangular with si > 0 on its diagonal, so never singular: the
    # unchecked solve (the same LU) spares the error check's host sync.
    H = torch.linalg.solve_ex(_tmat(ci, si), Hn @ _tmat(co, so))[0]
    H = H / torch.linalg.matrix_norm(H, keepdim=True)
    sign = torch.where(H[..., 2:3, 2:3] < 0, -1.0, 1.0).to(H.dtype)
    return H * sign


def _normalized_rows(obj_xy, img_xy, mask):
    co, so = _masked_normalization(obj_xy, mask)
    ci, si = _masked_normalization(img_xy, mask)
    o = (obj_xy - co[..., None, :]) * so[..., None, None]
    p = (img_xy - ci[..., None, :]) * si[..., None, None]
    return (o[..., 0], o[..., 1], p[..., 0], p[..., 1]), (co, so, ci, si)


def homography_dlt(obj_xy: torch.Tensor, img_xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalized DLT homography: obj plane (z=0) -> image. Batched.

    obj_xy, img_xy: (..., P, 2); mask: (..., P). Returns (..., 3, 3) with
    ||H||_F = 1 and H[2,2] >= 0.
    """
    (x, y, u, v), stats = _normalized_rows(obj_xy, img_xy, mask)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * mask[..., None], r2 * mask[..., None]], dim=-2)
    # h = right singular vector of the smallest singular value; the minimal
    # 4-point system is (8, 9), so pad to at least 9 rows.
    if A.shape[-2] < A.shape[-1]:
        A = torch.nn.functional.pad(A, (0, 0, 0, A.shape[-1] - A.shape[-2]))
    vt = torch.linalg.svd(A, full_matrices=False)[2]
    h = vt[..., -1, :]
    return _denormalize(h.reshape(h.shape[:-1] + (3, 3)), *stats)


def homography_ls(obj_xy: torch.Tensor, img_xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalized least-squares homography with h33 = 1. Batched.

    Same contract as :func:`homography_dlt`, solved through the 8x8 normal
    equations of the inhomogeneous DLT system instead of an SVD nullspace;
    degenerate inputs give a non-finite H.
    """
    (x, y, u, v), stats = _normalized_rows(obj_xy, img_xy, mask)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    A = torch.cat([r1 * mask[..., None], r2 * mask[..., None]], dim=-2)
    b = torch.cat([u * mask, v * mask], dim=-1)
    AtA = A.transpose(-1, -2) @ A
    AtA = AtA + 1e-9 * torch.eye(8, dtype=A.dtype, device=A.device)
    Atb = torch.einsum("...pi,...p->...i", A, b)
    h = torch.linalg.solve_ex(AtA, Atb[..., None])[0][..., 0]
    Hn = torch.cat([h, torch.ones(h.shape[:-1] + (1,), dtype=h.dtype, device=h.device)],
                   -1).reshape(h.shape[:-1] + (3, 3))
    return _denormalize(Hn, *stats)


def zhang_focal(Hs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Closed-form shared focal from view homographies (Zhang 2000).

    Homographies must be expressed with pixel coordinates centered on the
    assumed principal point. Returns a scalar focal estimate (median over
    both constraint families across valid views).
    """
    h1 = Hs[..., :, 0]
    h2 = Hs[..., :, 1]
    # Constraint 1: h1' w h2 = 0, w = diag(1/f^2, 1/f^2, 1)
    num1 = -(h1[..., 2] * h2[..., 2])
    den1 = h1[..., 0] * h2[..., 0] + h1[..., 1] * h2[..., 1]
    inv_f2_a = num1 / torch.where(torch.abs(den1) > 1e-12, den1, torch.full_like(den1, 1e-12))
    # Constraint 2: h1' w h1 = h2' w h2
    num2 = h2[..., 2] ** 2 - h1[..., 2] ** 2
    den2 = h1[..., 0] ** 2 + h1[..., 1] ** 2 - h2[..., 0] ** 2 - h2[..., 1] ** 2
    inv_f2_b = num2 / torch.where(torch.abs(den2) > 1e-12, den2, torch.full_like(den2, 1e-12))
    cands = torch.cat([inv_f2_a, inv_f2_b], dim=-1)
    ok = torch.cat([valid, valid], dim=-1) & (cands > 1e-12) & torch.isfinite(cands)
    # Masked median: sort with invalid pushed to +inf, index by count/2.
    vals = torch.sort(torch.where(ok, cands, torch.full_like(cands, float("inf"))), dim=-1)[0]
    k = torch.clamp(torch.sum(ok, -1), min=1)
    med = torch.take_along_dim(vals, ((k - 1) // 2)[..., None], dim=-1)[..., 0]
    return 1.0 / torch.sqrt(torch.clamp(med, min=1e-12))


def pose_from_homography(H: torch.Tensor, f: torch.Tensor, cc: torch.Tensor):
    """Decompose plane homography into (q_cam_board, t) given focal/pp.

    Returns the transform mapping board coordinates into the camera frame.
    """
    Kinv_diag = torch.stack([1.0 / f, 1.0 / f, torch.ones_like(f)], -1)
    Hc = torch.stack([H[..., 0, :] + (-cc[..., 0, None] * H[..., 2, :]),
                      H[..., 1, :] + (-cc[..., 1, None] * H[..., 2, :]),
                      H[..., 2, :]], dim=-2)
    M = Kinv_diag[..., :, None] * Hc
    m1, m2, m3 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    lam = 1.0 / torch.clamp(torch.linalg.vector_norm(m1, dim=-1), min=1e-12)
    # Cheirality: the board must be in front of the camera.
    sgn = torch.where(m3[..., 2] * lam < 0, -1.0, 1.0).to(H.dtype)[..., None]
    r1 = m1 * lam[..., None] * sgn
    r2 = m2 * lam[..., None] * sgn
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    R = torch.stack([r1, r2, r3], dim=-1)
    # Project onto SO(3).
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    Rp = (U * D[..., None, :]) @ Vt
    t = m3 * lam[..., None] * sgn
    return lie.matrix_to_quat(Rp), t


def radial_division_init(obj_xy: torch.Tensor, img_centered: torch.Tensor,
                         mask: torch.Tensor, lambdas: torch.Tensor):
    """Distortion-aware uncalibrated init: batched division-model lambda grid.

    Every candidate division coefficient in ``lambdas`` (1/px^2 on
    principal-point-centered pixels) is evaluated at once, as one batch
    over (lambda, view): undistort all corners, fit per-view homographies,
    redistort the homography-predicted points with the closed-form
    division forward map, and score by the masked mean transfer error in
    the distorted pixel frame.

    obj_xy: (V, P, 2) board-plane coords; img_centered: (V, P, 2); mask:
    (V, P); lambdas: (L,). Returns (best_lambda, Hs_best (V,3,3),
    err_per_lambda (L,)).
    """
    r2 = torch.sum(img_centered ** 2, -1)  # (V, P)
    lam = lambdas[:, None, None]  # (L, 1, 1)
    # A candidate for which 1 + lam r^2 crosses zero inside the field is
    # clamped here and scored out by the transfer error below.
    den = 1.0 + lam * r2
    und = img_centered / torch.where(torch.abs(den) > 1e-3, den,
                                     torch.full_like(den, 1e-3))[..., None]
    L = lambdas.shape[0]
    obj_b = obj_xy.expand((L,) + obj_xy.shape)
    Hs = homography_dlt(obj_b, und, mask.expand((L,) + mask.shape))  # (L, V, 3, 3)
    one = torch.ones(obj_xy.shape[:-1] + (1,), dtype=obj_xy.dtype, device=obj_xy.device)
    ph = torch.einsum("lvij,vpj->lvpi", Hs, torch.cat([obj_xy, one], -1))
    pu = ph[..., :2] / torch.where(torch.abs(ph[..., 2:]) > 1e-9, ph[..., 2:],
                                   torch.full_like(ph[..., 2:], 1e-9))
    # Closed-form division forward map (redistort): r_d = s * r_u with
    # s = 2 / (1 + sqrt(1 - 4 lam r_u^2)).
    ru2 = torch.sum(pu ** 2, -1)
    disc = torch.clamp(1.0 - 4.0 * lam * ru2, min=0.0)
    s = 2.0 / (1.0 + torch.sqrt(disc))
    pd = pu * s[..., None]
    err = torch.linalg.vector_norm(pd - img_centered, dim=-1)
    n = torch.clamp(torch.sum(mask), min=1.0)
    mean_err = torch.sum(err * mask, dim=(-2, -1)) / n
    errs = torch.where(torch.isfinite(mean_err), mean_err,
                       torch.full_like(mean_err, float("inf")))
    best = torch.argmin(errs)
    return lambdas[best], Hs[best], errs


def pnp_dlt(points3d: torch.Tensor, bearings_xy: torch.Tensor, mask: torch.Tensor):
    """Calibrated DLT PnP from normalized image coords (z=1 plane).

    points3d: (..., P, 3); bearings_xy: (..., P, 2); mask: (..., P).
    Returns (q_cam_world, t_cam_world): X_cam = R X + t.
    Needs >= 6 well-spread points.
    """
    X, Y, Z = points3d[..., 0], points3d[..., 1], points3d[..., 2]
    x, y = bearings_xy[..., 0], bearings_xy[..., 1]
    zero = torch.zeros_like(X)
    one = torch.ones_like(X)
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero, -x * X, -x * Y, -x * Z, -x], -1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one, -y * X, -y * Y, -y * Z, -y], -1)
    m = mask.to(points3d.dtype)[..., None]
    A = torch.cat([r1 * m, r2 * m], dim=-2)
    vt = torch.linalg.svd(A, full_matrices=False)[2]
    p = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 4))
    # The DLT solution is +-lambda [R|t]; the correct sign makes the
    # rotation part have positive determinant.
    s = torch.sign(torch.linalg.det(p[..., :3]))[..., None, None]
    p = p * torch.where(s == 0, torch.ones_like(s), s)
    R_raw = p[..., :3]
    t_raw = p[..., 3]
    U, S, Vt = torch.linalg.svd(R_raw)
    scale = 3.0 / torch.clamp(torch.sum(S, -1), min=1e-12)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (U * D[..., None, :]) @ Vt
    t = t_raw * scale[..., None]
    return lie.matrix_to_quat(R), t


def reprojection_errors_normalized(q, t, points3d, bearings_xy, mask):
    """Squared reprojection error on the normalized image plane (inf where
    masked or behind the camera)."""
    pc = lie.quat_rotate(q[..., None, :], points3d) + t[..., None, :]
    z = pc[..., 2]
    zz = z[..., None]
    proj = pc[..., :2] / torch.where(torch.abs(zz) > 1e-9, zz, torch.full_like(zz, 1e-9))
    err2 = torch.sum((proj - bearings_xy) ** 2, -1)
    return torch.where(mask & (z > 1e-6), err2, torch.full_like(err2, float("inf")))


def _gumbel_subsets(uniforms: torch.Tensor, mask: torch.Tensor, sample_size: int):
    """Weighted sampling without replacement: Gumbel top-k over the valid
    points. uniforms (..., K, P), mask (..., P) -> indices (..., K, S)."""
    gumbel = -torch.log(-torch.log(uniforms + 1e-12) + 1e-12)
    scores = torch.where(mask[..., None, :], gumbel, torch.full_like(gumbel, float("-inf")))
    return torch.topk(scores, sample_size, dim=-1)[1]


def _take_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., P, d) gathered at idx (..., K, S) -> (..., K, S, d)."""
    return torch.take_along_dim(x[..., None, :, :], idx[..., None], dim=-2)


def _best_hypothesis(qs, ts, points3d, bearings_xy, mask, inlier_thresh):
    """Score every hypothesis (..., K) on all points; the first with the
    most inliers wins: (q, t, inlier mask, count)."""
    errs = reprojection_errors_normalized(qs, ts, points3d[..., None, :, :],
                                          bearings_xy[..., None, :, :], mask[..., None, :])
    inl = errs < inlier_thresh ** 2
    counts = torch.sum(inl, -1)
    best = torch.argmax(counts, dim=-1, keepdim=True)
    q = torch.take_along_dim(qs, best[..., None], dim=-2)[..., 0, :]
    t = torch.take_along_dim(ts, best[..., None], dim=-2)[..., 0, :]
    inl_b = torch.take_along_dim(inl, best[..., None], dim=-2)[..., 0, :]
    return q, t, inl_b, torch.take_along_dim(counts, best, dim=-1)[..., 0]


def _ransac_pnp_planar(points3d, bearings_xy, mask, uniforms, sample_size: int = 6,
                       inlier_thresh: float = 0.01):
    """:func:`ransac_pnp_planar` on given uniforms (..., K, P)."""
    idx = _gumbel_subsets(uniforms, mask, sample_size)
    pts = points3d.expand(bearings_xy.shape[:-1] + (3,))
    obj_s = _take_points(pts[..., :2], idx)
    brg_s = _take_points(bearings_xy, idx)
    msk_s = _take_points(mask[..., None], idx)[..., 0].to(bearings_xy.dtype)
    Hs = homography_dlt(obj_s, brg_s, msk_s)
    batch = Hs.shape[:-2]
    f1 = torch.ones(batch, dtype=bearings_xy.dtype, device=bearings_xy.device)
    cc0 = torch.zeros(batch + (2,), dtype=bearings_xy.dtype, device=bearings_xy.device)
    qs, ts = pose_from_homography(Hs, f1, cc0)
    return _best_hypothesis(qs, ts, pts, bearings_xy, mask, inlier_thresh)


def ransac_pnp_planar(points3d: torch.Tensor, bearings_xy: torch.Tensor, mask: torch.Tensor,
                      generator: torch.Generator, num_hypotheses: int = 128,
                      sample_size: int = 6, inlier_thresh: float = 0.01):
    """RANSAC pose for PLANAR targets (z == 0) from normalized image coords.

    The 3D DLT is degenerate for coplanar points, so hypotheses come from
    minimal homographies (board plane -> normalized image plane) decomposed
    with f=1, pp=0. Same fixed-size batched structure as
    :func:`ransac_pnp`; the uniforms come from ``generator``.
    """
    u = torch.rand(mask.shape[:-1] + (num_hypotheses, mask.shape[-1]), generator=generator,
                   dtype=bearings_xy.dtype, device=bearings_xy.device)
    return _ransac_pnp_planar(points3d, bearings_xy, mask, u, sample_size, inlier_thresh)


def _ransac_pnp(points3d, bearings_xy, mask, uniforms, sample_size: int = 6,
                inlier_thresh: float = 0.01):
    """:func:`ransac_pnp` on given uniforms (..., K, P)."""
    idx = _gumbel_subsets(uniforms, mask, sample_size)
    pts = points3d.expand(bearings_xy.shape[:-1] + (3,))
    qs, ts = pnp_dlt(_take_points(pts, idx), _take_points(bearings_xy, idx),
                     _take_points(mask[..., None], idx)[..., 0])
    return _best_hypothesis(qs, ts, pts, bearings_xy, mask, inlier_thresh)


def ransac_pnp(points3d: torch.Tensor, bearings_xy: torch.Tensor, mask: torch.Tensor,
               generator: torch.Generator, num_hypotheses: int = 128, sample_size: int = 6,
               inlier_thresh: float = 0.01):
    """Fixed-size-batch RANSAC PnP.

    Samples ``num_hypotheses`` 6-point subsets (uniforms from
    ``generator``), solves all with one batched SVD, scores all, returns
    the best pose, its inlier mask and the inlier count.
    """
    u = torch.rand(mask.shape[:-1] + (num_hypotheses, mask.shape[-1]), generator=generator,
                   dtype=bearings_xy.dtype, device=bearings_xy.device)
    return _ransac_pnp(points3d, bearings_xy, mask, u, sample_size, inlier_thresh)
