"""Batched Lie-group operations on SO(3)/SE(3), quaternion-based.

Port of ``ops/lie.py`` of the JAX package. Every function is a pure
function of tensors with leading batch dimensions, safe under
``torch.func`` transforms (``vmap``, ``jvp``, ``jacfwd``, ``jacrev``).
``torch.where`` differentiates both branches, like ``jnp.where``, so the
small-angle guards are reproduced exactly: the radicand and the divisors
are clamped inside the branch that is not taken, which keeps the unused
branch finite and its gradient NaN-free.

Conventions
-----------
* Quaternions are ``(..., 4)`` tensors ordered ``(w, x, y, z)`` (Hamilton).
* ``quat_rotate(q, v) == R(q) @ v`` (active rotation).
* SE(3) is carried as a ``(quat, trans)`` pair; ``se3_act`` maps points by
  ``R v + t``.
* ``so3_exp``/``so3_log`` map axis-angle tangent vectors (rad) to/from unit
  quaternions.
"""

from __future__ import annotations

import torch

_SMALL = 1e-8


def _safe_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Norm with a gradient that is finite at 0 (returns 0 there)."""
    sq = torch.sum(v * v, dim=dim)
    # Avoid sqrt(0) gradient NaN: clamp under the radical, zero the output.
    norm = torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
    return torch.where(sq > 0, norm, torch.zeros_like(norm))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (broadcasting, transform-safe)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_identity(dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_multiply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p, batched over leading dims."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse for possibly non-unit quaternions."""
    return quat_conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q: R(q) v (15-mul form)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w,x,y,z), Shepperd's method.

    Branch-free: all four candidates are computed and the best-conditioned
    one is selected, so it is safe under vmap.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    c0 = 1.0 + tr
    c1 = 1.0 + m00 - m11 - m22
    c2 = 1.0 - m00 + m11 - m22
    c3 = 1.0 - m00 - m11 + m22
    cands = torch.stack([c0, c1, c2, c3], dim=-1)
    idx = torch.argmax(cands, dim=-1)

    def s_of(c):
        return torch.sqrt(torch.clamp(c, min=_SMALL)) * 2.0

    s = s_of(c0)
    from_w = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
    s = s_of(c1)
    from_x = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)
    s = s_of(c2)
    from_y = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)
    s = s_of(c3)
    from_z = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)

    qs = torch.stack([from_w, from_x, from_y, from_z], dim=-2)  # (..., 4, 4)
    gidx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(qs, -2, gidx)[..., 0, :]
    # Canonicalize sign (w >= 0) and normalize.
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion, Taylor-safe at 0."""
    theta = _safe_norm(phi)[..., None]
    half = 0.5 * theta
    small = theta < 1e-4
    # sin(x/2)/x and cos(x/2); Taylor for tiny angles.
    k = torch.where(
        small,
        0.5 - theta * theta / 48.0,
        torch.sin(half) / torch.where(theta > 0, theta, torch.ones_like(theta)),
    )
    w = torch.cos(half)
    return torch.cat([w, k * phi], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> axis-angle (..., 3), in (-pi, pi], Taylor-safe."""
    w = q[..., 0:1]
    v = q[..., 1:4]
    # Double cover: force w >= 0 so the angle is minimal.
    neg = w < 0
    w = torch.where(neg, -w, w)
    v = torch.where(neg, -v, v)
    vn = _safe_norm(v)[..., None]
    small = vn < 1e-6
    # theta = 2 atan2(|v|, w); phi = theta * v/|v|
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(
        small,
        2.0 / torch.clamp(w, min=0.5) * (1.0 + vn * vn / (3.0 * torch.clamp(w * w, min=0.25))),
        theta / torch.where(vn > 0, vn, torch.ones_like(vn)),
    )
    return scale * v


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation q0 -> q1 at fraction(s) t in [0, 1]."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)  # shortest arc
    rel = quat_multiply(quat_conjugate(q0), q1)
    return quat_multiply(q0, so3_exp(t * so3_log(rel)))


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SE(3) as (quat, trans) pairs
# ---------------------------------------------------------------------------

def se3_act(q: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply rigid transform: R(q) p + t."""
    return quat_rotate(q, p) + t


def se3_compose(qa, ta, qb, tb):
    """T_a * T_b -> (q, t)."""
    return quat_multiply(qa, qb), quat_rotate(qa, tb) + ta


def se3_inverse(q, t):
    qi = quat_conjugate(q)
    return qi, -quat_rotate(qi, t)


def se3_exp(xi: torch.Tensor):
    """(..., 6) tangent (rho, phi) -> (q, t) with exact V matrix."""
    rho, phi = xi[..., :3], xi[..., 3:]
    q = so3_exp(phi)
    theta = _safe_norm(phi)[..., None, None]
    K = skew(phi)
    small = theta < 1e-4
    t2 = theta * theta
    one = torch.ones_like(theta)
    th = torch.where(small, one, theta)
    A = torch.where(small, 0.5 - t2 / 24.0, (1 - torch.cos(th)) / torch.where(small, one, t2))
    B = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (th - torch.sin(th)) / torch.where(small, one, t2 * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    V = eye + A * K + B * (K @ K)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return q, t


def quat_boxplus(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Right-retraction on SO(3): q ⊞ δ = q ⊗ exp(δ)."""
    return quat_multiply(q, so3_exp(delta))


def quat_boxminus(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """log(qb^{-1} ⊗ qa): the δ with qb ⊞ δ = qa."""
    return so3_log(quat_multiply(quat_conjugate(qb), qa))
