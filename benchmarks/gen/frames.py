"""Rendered charuco frames: the benchmark's frozen copy of the port's
``utils/recorded.charuco_texture`` / ``render_frames`` (with the marker
renderer of ``detect/render.py`` and the DICT_ARUCO_ORIGINAL bit patterns of
``detect/aruco_dict.py``), and the frames' corner truth.

Frames render in blocks on the device (the port renders one at a time) and
the sensor noise is drawn there from a ``torch.Generator``; without noise a
frame is the port's, bit for bit (``benchmarks/tests/test_bench_frozen.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmarks.gen import scene as sc

# DICT_ARUCO_ORIGINAL: each 5-cell row encodes two id bits (1 = white).
_ROW_PATTERNS = np.array([[1, 0, 0, 0, 0], [1, 0, 1, 1, 1], [0, 1, 0, 0, 1], [0, 1, 1, 1, 0]],
                         dtype=np.uint8)


def aruco_original_bits(marker_id: int) -> np.ndarray:
    return np.stack([_ROW_PATTERNS[(marker_id >> (8 - 2 * i)) & 0x3]
                     for i in range(5)]).astype(np.uint8)


def _marker_image(marker_id: int, px: int) -> np.ndarray:
    cells = np.zeros((7, 7), np.uint8)
    cells[1:6, 1:6] = aruco_original_bits(marker_id)
    idx = (np.arange(px) * 7 // px).clip(0, 6)
    return (cells[np.ix_(idx, idx)] * 255).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class BoardTexture:
    """Board image; board point (x, y) m is at texture pixel
    (margin + x / square * pps - 0.5, margin + y / square * pps - 0.5)."""

    image: np.ndarray
    px_per_square: int
    margin_px: int
    square_length: float


def charuco_texture(squares_x: int = 10, squares_y: int = 8, square_length: float = 0.04,
                    marker_length: float = 0.03, px_per_square: int = 64,
                    margin_px: int = 32) -> BoardTexture:
    """OpenCV's charuco layout: square (sx, sy) black when sx + sy is even,
    markers 0, 1, ... centred in the white squares, row-major."""
    pps = px_per_square
    img = np.full((squares_y * pps + 2 * margin_px, squares_x * pps + 2 * margin_px), 255,
                  np.uint8)
    marker_px = max(2, int(round(marker_length / square_length * pps)))
    off = (pps - marker_px) // 2
    mid = 0
    for sy in range(squares_y):
        for sx in range(squares_x):
            y0, x0 = margin_px + sy * pps, margin_px + sx * pps
            if (sx + sy) % 2 == 0:
                img[y0:y0 + pps, x0:x0 + pps] = 0
            else:
                img[y0 + off:y0 + off + marker_px,
                    x0 + off:x0 + off + marker_px] = _marker_image(mid % 1024, marker_px)
                mid += 1
    return BoardTexture(img, px_per_square, margin_px, square_length)


def _unproject(model_name, cam, uv):
    """Unit rays of pixels ``uv`` (..., 2) through the camera model."""
    if model_name == "division_undistortion":
        f, cx, cy, d = (cam[i] for i in range(4))
        xd, yd = uv[..., 0] - cx, uv[..., 1] - cy
        w = 1.0 + d * (xd * xd + yd * yd)
        ray = torch.stack([sc._safe_div(xd, w) / f, sc._safe_div(yd, w) / f,
                           torch.ones_like(xd)], -1)
    else:
        fx, fy, cx, cy, xi, alpha = (cam[i] for i in range(6))
        mx, my = (uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy
        r2 = mx * mx + my * my
        inner = 1.0 - (2.0 * alpha - 1.0) * r2
        mz = (1.0 - alpha * alpha * r2) / (alpha * torch.sqrt(torch.clamp(inner, min=sc._EPS))
                                           + 1.0 - alpha)
        k = ((mz * xi + torch.sqrt(torch.clamp(mz * mz + (1.0 - xi * xi) * r2, min=sc._EPS)))
             / torch.clamp(mz * mz + r2, min=sc._EPS))
        ray = torch.stack([k * mx, k * my, k * mz - xi], -1)
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)


def _render_block(cam, q_rows, t_rows, texture, tex_scale, tex_offset, model_name, image_size,
                  supersample, background=170.0):
    """(B, H, W) frames from per-row camera poses (B, H, 4) / (B, H, 3)."""
    W, H = image_size
    s = supersample
    dt, dev = cam.dtype, cam.device
    u = (torch.arange(W * s, dtype=dt, device=dev) + 0.5) / s - 0.5
    v = (torch.arange(H * s, dtype=dt, device=dev) + 0.5) / s - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    ray_c = _unproject(model_name, cam, torch.stack([uu, vv], dim=-1))  # (Hs, Ws, 3)
    row = torch.clamp(torch.arange(H * s, device=dev) // s, 0, q_rows.shape[1] - 1)
    d_w = sc.quat_rotate(q_rows[:, row][:, :, None, :], ray_c)  # (B, Hs, Ws, 3)
    o_w = t_rows[:, row][:, :, None, :]
    dz = d_w[..., 2]
    tz = -o_w[..., 2] / torch.where(torch.abs(dz) < 1e-9, torch.full_like(dz, 1e-9), dz)
    X = o_w + tz[..., None] * d_w
    hit = (tz > 0.05) & (ray_c[..., 2] > 0.05)
    px, py = tex_offset + X[..., 0] * tex_scale, tex_offset + X[..., 1] * tex_scale
    Ht, Wt = texture.shape
    inside = (px >= 0) & (px <= Wt - 1.001) & (py >= 0) & (py <= Ht - 1.001)
    pxc, pyc = torch.clamp(px, 0.0, Wt - 1.001), torch.clamp(py, 0.0, Ht - 1.001)
    x0, y0 = torch.floor(pxc).to(torch.int64), torch.floor(pyc).to(torch.int64)
    du, dv = pxc - x0, pyc - y0
    tex = texture.to(dt)
    val = (tex[y0, x0] * (1 - du) * (1 - dv) + tex[y0, x0 + 1] * du * (1 - dv)
           + tex[y0 + 1, x0] * (1 - du) * dv + tex[y0 + 1, x0 + 1] * du * dv)
    img = torch.where(hit & inside, val, torch.full_like(val, background))
    B = img.shape[0]
    return img.reshape(B, H, s, W, s).mean(dim=(2, 4))


def render_frames(pose_fn, stamp_times, model_name: str, cam_params, q_i_c, t_i_c,
                  tex: BoardTexture, image_size, *, time_offset: float = 0.0,
                  line_delay: float = 0.0, supersample: int = 2, noise_std: float = 1.5,
                  seed: int = 0, block: int = 8, device, dtype=torch.float32) -> torch.Tensor:
    """(V, H, W) uint8 frames on ``device`` for camera-clock stamps: frame t
    is exposed at IMU time t + time_offset, its row r at
    t + time_offset + line_delay * r; noise of ``noise_std`` DN from a
    ``torch.Generator`` on the device seeded ``seed``."""
    W, H = image_size
    cam = torch.as_tensor(np.asarray(cam_params, np.float64), dtype=dtype, device=device)
    q_i_c = torch.as_tensor(np.asarray(q_i_c, np.float64), device=device)
    t_i_c = torch.as_tensor(np.asarray(t_i_c, np.float64), device=device)
    tex_img = torch.as_tensor(tex.image, device=device)
    tex_scale = tex.px_per_square / tex.square_length
    rows = torch.arange(H, dtype=torch.float64, device=device)
    stamps = torch.as_tensor(np.asarray(stamp_times, np.float64), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    out = torch.empty((len(stamp_times), H, W), dtype=torch.uint8, device=device)
    for b in range(0, len(stamp_times), block):
        t = stamps[b:b + block, None] + time_offset + line_delay * rows
        qi, pi = pose_fn(t)
        q_rows, p_rows = sc.se3_compose(qi, pi, q_i_c, t_i_c)
        img = _render_block(cam, q_rows.to(dtype), p_rows.to(dtype), tex_img, tex_scale,
                            tex.margin_px - 0.5, model_name, (W, H), supersample)
        if noise_std > 0:
            img = img + noise_std * torch.randn(img.shape, generator=gen, dtype=img.dtype,
                                                device=device)
        out[b:b + block] = torch.clamp(img, 0, 255).to(torch.uint8)
    return out
