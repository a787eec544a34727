"""Image primitives for target detection.

Port of ``detect/image.py`` of the JAX package: adaptive threshold,
gradients, bilinear sampling, the checkerboard corner response and its
candidates, and subpixel refinement, as torch array programs on the
frame's device. Like the JAX package, every function works in float32.

``corner_response`` and ``find_corner_candidates`` dispatch by the
tensor's device, as ``solver/gram.py`` does: a CPU tensor takes the plain
version (``detect/kernels.corner_response_nms_plain``), a CUDA tensor the
hand-written kernel (``detect/kernels.corner_response_nms``). There is no
knob that sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Filtering / thresholding
# ---------------------------------------------------------------------------

def _pad_replicate(img: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicated padding by r of the last two axes of (..., H, W)."""
    h, w = img.shape[-2:]
    pad = F.pad(img.reshape(-1, 1, h, w), (r, r, r, r), mode="replicate")
    return pad.reshape(img.shape[:-2] + pad.shape[-2:])


def box_mean(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Local mean over a (2r+1)^2 window with edge-replicated borders
    (two separable windowed sums), of a frame (H, W) or of each frame of
    (..., H, W)."""
    r = int(radius)
    k = 2 * r + 1
    pad = _pad_replicate(img.to(torch.float32), r)
    s = pad.unfold(-2, k, 1).sum(-1)
    s = s.unfold(-1, k, 1).sum(-1)
    return s / (k * k)


def adaptive_threshold(img: torch.Tensor, radius: int = 10, c: float = 7.0):
    """Binary image: True where pixel < local_mean - c (dark regions),
    the polarity aruco uses for marker candidates."""
    m = box_mean(img, radius)
    return img.to(torch.float32) < m - c


def gradients(img: torch.Tensor):
    """(gx, gy) central-difference gradients, edge-replicated, of (H, W)
    or of each frame of (..., H, W)."""
    fp = _pad_replicate(img.to(torch.float32), 1)
    gx = (fp[..., 1:-1, 2:] - fp[..., 1:-1, :-2]) * 0.5
    gy = (fp[..., 2:, 1:-1] - fp[..., :-2, 1:-1]) * 0.5
    return gx, gy


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Sample img (H, W, ...) at float pixel coords (u=x, v=y), clamped."""
    h, w = img.shape[:2]
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    du = u - u0
    dv = v - v0
    if img.dim() > 2:  # trailing channels: broadcast the weights over them
        du, dv = du[..., None], dv[..., None]
    i00 = img[v0, u0]
    i01 = img[v0, u0 + 1]
    i10 = img[v0 + 1, u0]
    i11 = img[v0 + 1, u0 + 1]
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


def bilinear_sample_frames(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """:func:`bilinear_sample` of each frame of imgs (F, H, W, ...) at its
    own coords u, v (F, ...): the JAX package's ``vmap`` over frames."""
    h, w = imgs.shape[1:3]
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    du = u - u0
    dv = v - v0
    if imgs.dim() > 3:
        du, dv = du[..., None], dv[..., None]
    f = torch.arange(imgs.shape[0], device=imgs.device).reshape((-1,) + (1,) * (u.dim() - 1))
    i00 = imgs[f, v0, u0]
    i01 = imgs[f, v0, u0 + 1]
    i10 = imgs[f, v0 + 1, u0]
    i11 = imgs[f, v0 + 1, u0 + 1]
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


def sample_homography_grid(img: torch.Tensor, H: torch.Tensor, nx: int, ny: int,
                           oversample: int = 3, margin: float = 0.0):
    """Mean intensity of an (ny, nx) cell grid mapped by homography H
    (unit square -> image pixels). Each cell is averaged over
    oversample^2 interior samples; ``margin`` ignores that fraction of
    the cell on every side. Returns (ny, nx), or (..., ny, nx) for a
    batch of homographies H (..., 3, 3) (the JAX package's ``vmap`` over
    H); for a block of frames img (F, H, W), H is (F, ..., 3, 3) and each
    frame is sampled under its own homographies. Coordinates are computed
    in H's dtype."""
    s = oversample
    dev, dt = H.device, H.dtype
    idx = torch.arange(nx * s, device=dev)
    cx = (idx // s).to(dt) / nx + (margin + ((idx % s).to(dt) + 0.5) / s
                                   * (1.0 - 2.0 * margin)) / nx
    idy = torch.arange(ny * s, device=dev)
    cy = (idy // s).to(dt) / ny + (margin + ((idy % s).to(dt) + 0.5) / s
                                   * (1.0 - 2.0 * margin)) / ny
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    ones = torch.ones_like(gx)
    grid = torch.stack([gx, gy, ones], dim=-1)
    pts = grid @ H.T if H.dim() == 2 else grid @ H.mT[..., None, :, :]
    u = pts[..., 0] / pts[..., 2]
    v = pts[..., 1] / pts[..., 2]
    sample = bilinear_sample if img.dim() == 2 else bilinear_sample_frames
    vals = sample(img.to(torch.float32), u, v)
    return vals.reshape(vals.shape[:-2] + (ny, s, nx, s)).mean(dim=(-3, -1))


# ---------------------------------------------------------------------------
# Subpixel corner refinement (cornerSubPix equivalent)
# ---------------------------------------------------------------------------

def _window(win: int, device):
    """Offsets (dx, dy) of the (2win+1)^2 window, row-major, and its
    Gaussian weights, float32."""
    r = int(win)
    ar = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(ar, ar, indexing="ij")
    wgt = torch.exp(-(dx * dx + dy * dy) / (2.0 * (r / 2.0) ** 2)).reshape(-1)
    return dx.reshape(-1), dy.reshape(-1), wgt


def _solve_step(A, b, c, r: float):
    """sol = (A + 1e-9 I)^-1 b per corner, kept where finite and within
    r + 1 of the current iterate c, else c."""
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    sol = torch.linalg.solve_ex(A + 1e-9 * eye, b[..., None])[0][..., 0]
    ok = (torch.isfinite(sol).all(-1)
          & (torch.linalg.vector_norm(sol - c, dim=-1) < (r + 1.0)))
    return torch.where(ok[..., None], sol, c)


def refine_corners_subpix(img: torch.Tensor, corners: torch.Tensor,
                          win: int = 5, iters: int = 8):
    """Gradient-orthogonality subpixel refinement of M corners.

    For the true corner c, every window pixel q satisfies
    grad(q) . (q - c) = 0. Solve the weighted least squares A c = b with
    A = sum w g g^T, b = sum w (g g^T) q per corner, iterated: OpenCV
    cornerSubPix's fixed point, vectorised over the corners.

    corners: (M, 2) float (x, y). Returns (M, 2) float32 refined.
    """
    gx, gy = gradients(img)
    dx, dy, wgt = _window(win, img.device)
    c = corners.to(device=img.device, dtype=torch.float32)
    if c.shape[0] == 0:
        return c
    for _ in range(iters):
        u = c[:, 0:1] + dx
        v = c[:, 1:2] + dy
        sgx = bilinear_sample(gx, u, v)
        sgy = bilinear_sample(gy, u, v)
        gxx = torch.sum(wgt * sgx * sgx, -1)
        gxy = torch.sum(wgt * sgx * sgy, -1)
        gyy = torch.sum(wgt * sgy * sgy, -1)
        bx = torch.sum(wgt * (sgx * sgx * u + sgx * sgy * v), -1)
        by = torch.sum(wgt * (sgx * sgy * u + sgy * sgy * v), -1)
        A = torch.stack([torch.stack([gxx, gxy], -1), torch.stack([gxy, gyy], -1)], -2)
        c = _solve_step(A, torch.stack([bx, by], -1), c, float(win))
    return c


def corner_refine_fields(img: torch.Tensor, win: int = 5) -> torch.Tensor:
    """(H, W, 5) correlation fields for conv-form subpixel refinement, or
    (F, H, W, 5) for a block of frames (F, H, W).

    The window sums of :func:`refine_corners_subpix` are
    cross-correlations of the fields (gx^2, gx gy, gy^2, gx^2 x + gx gy y,
    gx gy x + gy^2 y) with the fixed window w: computed once per image,
    each refinement iteration then samples 5 field values
    (:func:`refine_corners_from_fields`).
    """
    gx, gy = gradients(img)
    h, w = img.shape[-2:]
    X = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    Y = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    gxx, gxy, gyy = gx * gx, gx * gy, gy * gy
    f = torch.stack([gxx, gxy, gyy, gxx * X + gxy * Y, gxy * X + gyy * Y], dim=-3)
    r = int(win)
    out = F.conv2d(f.reshape(-1, 5, h, w), _field_window(r, img.device), padding=r, groups=5)
    return out.reshape(f.shape).movedim(-3, -1)


@functools.lru_cache(maxsize=None)
def _field_window(r: int, device) -> torch.Tensor:
    """(5, 1, 2r+1, 2r+1) f32: the Gaussian window of
    :func:`corner_refine_fields` for each field, on ``device`` (made once,
    so a call copies nothing from the host)."""
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij")
    wgt = np.exp(-(dx * dx + dy * dy) / (2.0 * (r / 2.0) ** 2)).astype(np.float32)
    return torch.as_tensor(np.broadcast_to(wgt, (5, 1) + wgt.shape).copy(), device=device)


def refine_corners_from_fields(fields: torch.Tensor, corners: torch.Tensor,
                               win: int = 5, iters: int = 8) -> torch.Tensor:
    """Subpixel refinement using precomputed :func:`corner_refine_fields`.

    corners: (M, 2) float (x, y), or (F, M, 2) with fields (F, H, W, 5)
    of a block of frames. Returns the same shape refined; steps farther
    than win+1 from the current iterate are rejected."""
    c = corners.to(device=fields.device, dtype=torch.float32)
    if c.shape[-2] == 0:
        return c
    sample = bilinear_sample if fields.dim() == 3 else bilinear_sample_frames
    for _ in range(iters):
        vals = sample(fields, c[..., 0], c[..., 1])  # (..., M, 5)
        A = torch.stack([vals[..., 0:2], vals[..., 1:3]], -2)
        c = _solve_step(A, vals[..., 3:5], c, float(win))
    return c


# ---------------------------------------------------------------------------
# Checkerboard (x-)corner response — Geiger-style prototype correlation
# ---------------------------------------------------------------------------

def _corner_prototype(radius: int, angle: float):
    """Four quadrant kernels (a, b, c, d) of a checkerboard corner prototype
    rotated by ``angle`` (libcbdetect's createCorrelationPatch)."""
    r = radius
    ys, xs = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij")
    n1 = np.array([-np.sin(angle), np.cos(angle)])
    n2 = np.array([-np.sin(angle + np.pi / 2), np.cos(angle + np.pi / 2)])
    d1 = xs * n1[0] + ys * n1[1]
    d2 = xs * n2[0] + ys * n2[1]
    dist = np.sqrt(xs * xs + ys * ys)
    g = np.exp(-dist ** 2 / (2.0 * (r / 2.0) ** 2))
    a = np.where((d1 <= -0.1) & (d2 <= -0.1), g, 0.0)
    b = np.where((d1 >= 0.1) & (d2 >= 0.1), g, 0.0)
    c = np.where((d1 <= -0.1) & (d2 >= 0.1), g, 0.0)
    d = np.where((d1 >= 0.1) & (d2 <= -0.1), g, 0.0)
    kernels = []
    for k in (a, b, c, d):
        s = k.sum()
        kernels.append((k / s if s > 0 else k).astype(np.float32))
    return np.stack(kernels)  # (4, size, size)


@functools.lru_cache(maxsize=None)
def _prototype_bank(radius: int):
    return np.stack([_corner_prototype(radius, 0.0),
                     _corner_prototype(radius, np.pi / 4)])  # (2, 4, s, s)


def corner_response(img: torch.Tensor, radius: int = 6):
    """Checkerboard-corner likelihood map float32 of a frame (H, W) or of a
    block of frames (F, H, W), same shape: the plain version on a CPU
    tensor, the CUDA kernel's block mode (response only, one launch per
    call) on a CUDA tensor."""
    from openimucameracalibrator_torch.detect import kernels

    if img.dim() not in (2, 3):
        raise ValueError(f"corner_response: img must be (H, W) or (F, H, W), "
                         f"got {tuple(img.shape)}")
    if img.device.type == "cpu":
        if img.dim() == 3:
            return kernels.corner_response_block_plain(img, radius)
        return kernels.corner_response_nms_plain(img, radius)[0]
    block = img.to(torch.float32).contiguous()
    resp = kernels.corner_response_block(block if img.dim() == 3 else block[None], radius)
    return resp if img.dim() == 3 else resp[0]


def find_corner_candidates(img: torch.Tensor, max_corners: int = 512,
                           nms_radius: int = 4, rel_threshold: float = 0.05,
                           response_radius: int = 6):
    """Top-K checkerboard corner candidates.

    Returns (xy (K, 2) float32, score (K,)) with score 0 for empty slots.
    NMS: a pixel survives if it equals the local max over the NMS window
    and exceeds ``rel_threshold`` times the frame's largest response.
    Equal scores come lower flat index first (the order of
    ``jax.lax.top_k``). A CPU tensor takes the plain version, a CUDA
    tensor the kernel.
    """
    from openimucameracalibrator_torch.detect import kernels

    if img.device.type == "cpu":
        resp, keep = kernels.corner_response_nms_plain(img, response_radius, nms_radius)
        return kernels.top_candidates(resp, keep, max_corners, rel_threshold)
    return kernels.find_corner_candidates_kernel(
        img.to(torch.float32).contiguous(), max_corners=max_corners, nms_radius=nms_radius,
        rel_threshold=rel_threshold, response_radius=response_radius)
