"""The seven camera models as pure, batched ``project``/``unproject`` pairs.

Port of ``models/cameras.py`` of the JAX package:

==================  =========================================
name                parameters
==================  =========================================
pinhole             [fx, fy, cx, cy]
pinhole_radtan      [fx, fy, cx, cy, k1, k2, k3, p1, p2]
division_undist     [f, cx, cy, d]
double_sphere       [fx, fy, cx, cy, xi, alpha]
extended_unified    [fx, fy, cx, cy, alpha, beta]
fov                 [fx, fy, cx, cy, w]
fisheye             [fx, fy, cx, cy, k1, k2, k3, k4]
==================  =========================================

Every function broadcasts over leading batch dims, is safe under
``torch.func`` transforms (no data-dependent Python control flow;
iterative inversions use a fixed iteration count), and returns a ``valid``
mask instead of a sentinel residual: invalid projections are masked out
of the loss by the solver.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence

import torch

from openimucameracalibrator_torch.utils import precision

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class CameraModel:
    name: str
    param_names: Sequence[str]
    project: Callable  # (params (...,P), p_cam (...,3)) -> (uv (...,2), valid (...,))
    unproject: Callable  # (params (...,P), uv (...,2)) -> bearing (...,3) unit norm
    init_params: Callable  # (f, cx, cy, dtype, device) -> (P,) initial parameter vector

    @property
    def num_params(self) -> int:
        return len(self.param_names)

    @property
    def param_groups(self) -> Dict[str, list]:
        """Indices by role (focal / principal point / distortion)."""
        groups = {"focal": [], "pp": [], "dist": []}
        for i, n in enumerate(self.param_names):
            if n in ("fx", "fy", "f"):
                groups["focal"].append(i)
            elif n in ("cx", "cy"):
                groups["pp"].append(i)
            else:
                groups["dist"].append(i)
        return groups


def _safe_div(a, b):
    sign_eps = torch.where(b >= 0, torch.full_like(b, _EPS), torch.full_like(b, -_EPS))
    return a / torch.where(torch.abs(b) > _EPS, b, sign_eps)


def _norm3(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _split(params, n):
    return tuple(params[..., i] for i in range(n))


# --- pinhole ---------------------------------------------------------------

def pinhole_project(params, p):
    fx, fy, cx, cy = _split(params, 4)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    u = fx * _safe_div(x, z) + cx
    v = fy * _safe_div(y, z) + cy
    return torch.stack([u, v], -1), z > _EPS


def pinhole_unproject(params, uv):
    fx, fy, cx, cy = _split(params, 4)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    return _norm3(torch.stack([mx, my, torch.ones_like(mx)], -1))


# --- pinhole + radial-tangential (OpenCV "plumb bob") ----------------------

def radtan_project(params, p):
    fx, fy, cx, cy, k1, k2, k3, p1, p2 = _split(params, 9)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    xn = _safe_div(x, z)
    yn = _safe_div(y, z)
    r2 = xn * xn + yn * yn
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * rad + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * rad + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return torch.stack([fx * xd + cx, fy * yd + cy], -1), z > _EPS


def radtan_unproject(params, uv):
    fx, fy, cx, cy, k1, k2, k3, p1, p2 = _split(params, 9)
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    # Fixed-point undistortion (8 iterations, the usual OpenCV scheme).
    xn, yn = xd, yd
    for _ in range(8):
        r2 = xn * xn + yn * yn
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
        dy = p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
        xn = (xd - dx) / rad
        yn = (yd - dy) / rad
    return _norm3(torch.stack([xn, yn, torch.ones_like(xn)], -1))


# --- division-undistortion (one-parameter division model, pixel space) -----

def divundist_project(params, p):
    f, cx, cy, d = _split(params, 4)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    xu = f * _safe_div(x, z)  # undistorted pixel, principal-point relative
    yu = f * _safe_div(y, z)
    ru2 = xu * xu + yu * yu
    # Solve r_u = r_d / (1 + d r_d^2) for r_d; scale s = r_d / r_u.
    disc = torch.clamp(1.0 - 4.0 * d * ru2, min=0.0)
    s = 2.0 / (1.0 + torch.sqrt(disc))  # == (1 - sqrt(disc)) / (2 d ru2), stable form
    return (torch.stack([s * xu + cx, s * yu + cy], -1),
            (z > _EPS) & (1.0 - 4.0 * d * ru2 > 0))


def divundist_unproject(params, uv):
    f, cx, cy, d = _split(params, 4)
    xd = uv[..., 0] - cx
    yd = uv[..., 1] - cy
    rd2 = xd * xd + yd * yd
    w = 1.0 + d * rd2
    return _norm3(torch.stack([_safe_div(xd, w) / f, _safe_div(yd, w) / f,
                               torch.ones_like(xd)], -1))


# --- double sphere (Usenko et al. 2018) ------------------------------------

def ds_project(params, p):
    fx, fy, cx, cy, xi, alpha = _split(params, 6)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d1 = torch.sqrt(x * x + y * y + z * z)
    zeta = xi * d1 + z
    d2 = torch.sqrt(x * x + y * y + zeta * zeta)
    denom = alpha * d2 + (1.0 - alpha) * zeta
    u = fx * _safe_div(x, denom) + cx
    v = fy * _safe_div(y, denom) + cy
    w1 = torch.where(alpha > 0.5, (1.0 - alpha) / torch.clamp(alpha, min=_EPS),
                     alpha / torch.clamp(1.0 - alpha, min=_EPS))
    w2 = (w1 + xi) / torch.sqrt(torch.clamp(2.0 * w1 * xi + xi * xi + 1.0, min=_EPS))
    return torch.stack([u, v], -1), (denom > _EPS) & (z > -w2 * d1)


def ds_unproject(params, uv):
    fx, fy, cx, cy, xi, alpha = _split(params, 6)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    inner = 1.0 - (2.0 * alpha - 1.0) * r2
    mz = (1.0 - alpha * alpha * r2) / (alpha * torch.sqrt(torch.clamp(inner, min=_EPS)) + 1.0 - alpha)
    k = ((mz * xi + torch.sqrt(torch.clamp(mz * mz + (1.0 - xi * xi) * r2, min=_EPS)))
         / torch.clamp(mz * mz + r2, min=_EPS))
    return _norm3(torch.stack([k * mx, k * my, k * mz - xi], -1))


# --- extended unified (EUCM) -----------------------------------------------

def eucm_project(params, p):
    fx, fy, cx, cy, alpha, beta = _split(params, 6)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d = torch.sqrt(beta * (x * x + y * y) + z * z)
    denom = alpha * d + (1.0 - alpha) * z
    u = fx * _safe_div(x, denom) + cx
    v = fy * _safe_div(y, denom) + cy
    w = torch.where(alpha > 0.5, (1.0 - alpha) / torch.clamp(alpha, min=_EPS),
                    alpha / torch.clamp(1.0 - alpha, min=_EPS))
    return torch.stack([u, v], -1), (denom > _EPS) & (z > -w * d)


def eucm_unproject(params, uv):
    fx, fy, cx, cy, alpha, beta = _split(params, 6)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    inner = 1.0 - (2.0 * alpha - 1.0) * beta * r2
    mz = ((1.0 - beta * alpha * alpha * r2)
          / (alpha * torch.sqrt(torch.clamp(inner, min=_EPS)) + 1.0 - alpha))
    return _norm3(torch.stack([mx, my, mz], -1))


# --- FOV (Devernay & Faugeras) ---------------------------------------------

def fov_project(params, p):
    fx, fy, cx, cy, w = _split(params, 5)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = torch.sqrt(x * x + y * y)
    tanwhalf = torch.tan(0.5 * w)
    theta = torch.atan2(2.0 * r * tanwhalf, z)
    mul = _safe_div(theta, w * torch.clamp(r, min=_EPS))
    mul = torch.where(r > _EPS, mul, _safe_div(2.0 * tanwhalf, w * torch.clamp(z, min=_EPS)))
    return (torch.stack([fx * x * mul + cx, fy * y * mul + cy], -1),
            torch.abs(w) > _EPS)


def fov_unproject(params, uv):
    fx, fy, cx, cy, w = _split(params, 5)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    rd = torch.sqrt(mx * mx + my * my)
    tanwhalf = torch.tan(0.5 * w)
    # r_undist/z = tan(rd*w) / (2 tan(w/2)); build the bearing directly.
    sin_t = torch.sin(rd * w)
    cos_t = torch.cos(rd * w)
    scale = torch.where(rd > _EPS, _safe_div(sin_t, 2.0 * tanwhalf * rd),
                        w / (2.0 * tanwhalf))
    return _norm3(torch.stack([scale * mx, scale * my, cos_t], -1))


# --- fisheye (Kannala-Brandt / OpenCV fisheye, 4 coefficients) -------------

def fisheye_project(params, p):
    fx, fy, cx, cy, k1, k2, k3, k4 = _split(params, 8)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    thetad = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r > _EPS, thetad / torch.clamp(r, min=_EPS),
                        _safe_div(torch.ones_like(z), z))
    return (torch.stack([fx * x * scale + cx, fy * y * scale + cy], -1),
            theta < math.pi - 1e-3)


def fisheye_unproject(params, uv):
    fx, fy, cx, cy, k1, k2, k3, k4 = _split(params, 8)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    thetad = torch.sqrt(mx * mx + my * my)
    # Newton iterations for theta from thetad (fixed count).
    theta = thetad
    for _ in range(6):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - thetad
        df = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))
        theta = theta - _safe_div(f, df)
    scale = torch.where(thetad > _EPS, torch.sin(theta) / torch.clamp(thetad, min=_EPS),
                        torch.ones_like(thetad))
    return _norm3(torch.stack([scale * mx, scale * my, torch.cos(theta)], -1))


# ---------------------------------------------------------------------------

def _init(*extra_defaults):
    def fn(f, cx, cy, dtype=None, device=None):
        dev = precision.resolve_device(device)
        return torch.tensor([f, f, cx, cy] + list(extra_defaults),
                            dtype=precision.resolve(dtype, dev), device=dev)
    return fn


def _init_divundist(f, cx, cy, dtype=None, device=None):
    dev = precision.resolve_device(device)
    return torch.tensor([f, cx, cy, 0.0], dtype=precision.resolve(dtype, dev), device=dev)


CAMERA_MODELS: Dict[str, CameraModel] = {
    "pinhole": CameraModel(
        "pinhole", ("fx", "fy", "cx", "cy"), pinhole_project, pinhole_unproject, _init()),
    "pinhole_radtan": CameraModel(
        "pinhole_radtan", ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "p1", "p2"),
        radtan_project, radtan_unproject, _init(0.0, 0.0, 0.0, 0.0, 0.0)),
    "division_undistortion": CameraModel(
        "division_undistortion", ("f", "cx", "cy", "d"),
        divundist_project, divundist_unproject, _init_divundist),
    "double_sphere": CameraModel(
        "double_sphere", ("fx", "fy", "cx", "cy", "xi", "alpha"),
        ds_project, ds_unproject, _init(0.0, 0.5)),
    "extended_unified": CameraModel(
        "extended_unified", ("fx", "fy", "cx", "cy", "alpha", "beta"),
        eucm_project, eucm_unproject, _init(0.5, 1.0)),
    "fov": CameraModel(
        "fov", ("fx", "fy", "cx", "cy", "w"), fov_project, fov_unproject, _init(0.85)),
    "fisheye": CameraModel(
        "fisheye", ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"),
        fisheye_project, fisheye_unproject, _init(0.0, 0.0, 0.0, 0.0)),
}

# Abbreviations used by the reference CLI.
MODEL_ALIASES = {
    "PINHOLE": "pinhole", "PH": "pinhole",
    "PINHOLE_RADIAL_TANGENTIAL": "pinhole_radtan", "PHRT": "pinhole_radtan",
    "DIVISION_UNDISTORTION": "division_undistortion", "DIVUN": "division_undistortion",
    "DOUBLE_SPHERE": "double_sphere", "DS": "double_sphere",
    "EXTENDED_UNIFIED": "extended_unified", "EUCM": "extended_unified",
    "FOV": "fov",
    "FISHEYE": "fisheye", "KB": "fisheye",
}


def get_model(name: str) -> CameraModel:
    key = name if name in CAMERA_MODELS else MODEL_ALIASES.get(name.upper(), name.lower())
    return CAMERA_MODELS[key]
