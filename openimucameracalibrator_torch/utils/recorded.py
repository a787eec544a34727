"""Recorded-data harness: render full video frames from a ground-truth
trajectory.

Port of the rendering part of ``utils/recorded.py`` of the JAX package.
Frame synthesis is inverse-mapped and rolling-shutter exact: each output
pixel row r is rendered from the camera pose at t_frame + line_delay * r,
the pixel ray is unprojected through the true camera model (distortion
included), intersected with the board plane z = 0, and the board texture
is sampled bilinearly with supersampled anti-aliasing. The frames render
on the device; the degradations (flicker, sensor noise) are applied on the
host from ``np.random.default_rng(seed)``, draw for draw as in the JAX
package, so the same poses give the same frames.

``make_recording`` (video + GPMF telemetry muxing) comes in a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openimucameracalibrator_torch.detect import aruco_dict, render
from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.ops import lie
from openimucameracalibrator_torch.utils import precision


@dataclasses.dataclass(frozen=True)
class BoardTexture:
    """Rendered target image + its pixel<->meter mapping.

    Physical board point (x, y) meters maps to texture pixel
    (margin + x / square * pps - 0.5, margin + y / square * pps - 0.5)
    (pixel-center convention; board +y is texture-down, matching
    detect/render.py and models/boards.py).
    """

    image: np.ndarray  # (Ht, Wt) uint8
    px_per_square: int
    margin_px: int
    square_length: float

    def to_tex_px(self, xy_m):
        s = self.px_per_square / self.square_length
        return self.margin_px + xy_m * s - 0.5


def charuco_texture(squares_x: int = 10, squares_y: int = 8,
                    square_length: float = 0.04, marker_length: float = 0.03,
                    px_per_square: int = 64, margin_px: int = 32,
                    dictionary=None) -> BoardTexture:
    d = dictionary or aruco_dict.aruco_original_dictionary()
    img = render.render_charuco_board(d, squares_x, squares_y, square_length,
                                      marker_length, px_per_square, margin_px)
    return BoardTexture(img, px_per_square, margin_px, square_length)


def _render_frame(cam_params, q_wc_rows, t_wc_rows, texture, tex_scale: float,
                  tex_offset: float, model_name: str, image_size: tuple,
                  supersample: int, background: float = 170.0):
    """(H, W) frame from per-row camera poses (rolling-shutter exact), in
    the dtype and on the device of ``cam_params``; ``texture`` is a
    (Ht, Wt) tensor on that device."""
    model = cameras.get_model(model_name)
    W, H = image_size
    s = supersample
    dt, dev = cam_params.dtype, cam_params.device
    u = (torch.arange(W * s, dtype=dt, device=dev) + 0.5) / s - 0.5
    v = (torch.arange(H * s, dtype=dt, device=dev) + 0.5) / s - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H*s, W*s)
    ray_c = model.unproject(cam_params, torch.stack([uu, vv], dim=-1))  # (H*s, W*s, 3)
    row = torch.clamp(torch.arange(H * s, device=dev) // s, 0, q_wc_rows.shape[0] - 1)
    q_rows = q_wc_rows[row]  # (H*s, 4)
    t_rows = t_wc_rows[row]  # (H*s, 3)
    d_w = lie.quat_rotate(q_rows[:, None, :], ray_c)  # (H*s, W*s, 3)
    o_w = t_rows[:, None, :]
    dz = d_w[..., 2]
    tz = -o_w[..., 2] / torch.where(torch.abs(dz) < 1e-9, torch.full_like(dz, 1e-9), dz)
    X = o_w + tz[..., None] * d_w
    hit = (tz > 0.05) & (ray_c[..., 2] > 0.05)
    px = tex_offset + X[..., 0] * tex_scale
    py = tex_offset + X[..., 1] * tex_scale
    Ht, Wt = texture.shape
    inside = (px >= 0) & (px <= Wt - 1.001) & (py >= 0) & (py <= Ht - 1.001)
    pxc = torch.clamp(px, 0.0, Wt - 1.001)
    pyc = torch.clamp(py, 0.0, Ht - 1.001)
    x0 = torch.floor(pxc).to(torch.int64)
    y0 = torch.floor(pyc).to(torch.int64)
    du = pxc - x0
    dv = pyc - y0
    tex = texture.to(dt)
    val = (tex[y0, x0] * (1 - du) * (1 - dv) + tex[y0, x0 + 1] * du * (1 - dv)
           + tex[y0 + 1, x0] * (1 - du) * dv + tex[y0 + 1, x0 + 1] * du * dv)
    img = torch.where(hit & inside, val, torch.full_like(val, background))
    return img.reshape(H, s, W, s).mean(dim=(1, 3))


def render_frames(pose_fn, frame_stamp_times, model_name: str, cam_params,
                  q_i_c, t_i_c, tex: BoardTexture, image_size,
                  time_offset: float = 0.0, line_delay: float = 0.0,
                  supersample: int = 2, noise_std: float = 1.5, seed: int = 0,
                  motion_blur_s: float = 0.0, blur_taps: int = 3,
                  exposure_flicker: float = 0.0, flicker_hz: float = 8.0,
                  device=None, dtype=None):
    """uint8 numpy frames for container-stamped times ``frame_stamp_times``,
    rendered on ``device`` (default ``"cuda"``; float64 on the CPU, float32
    on the card).

    ``pose_fn(t)`` maps a float64 time tensor (any shape, on ``device``) to
    body poses ``(q_w_b (..., 4), p_w (..., 3))``, as
    ``synthetic.sinusoid_trajectory`` does. Frame stamped t is exposed at
    IMU time t + time_offset; pixel row r of a rolling-shutter frame at
    t + time_offset + line_delay * r.

    Degradations: ``motion_blur_s`` averages ``blur_taps`` renders across
    that exposure window; ``exposure_flicker`` is a relative sinusoidal
    gain at ``flicker_hz``; ``noise_std`` is additive sensor noise in DN.
    """
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    W, H = image_size

    def T(x, dt=torch.float64):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt, device=device)

    cam = T(cam_params, dtype)
    q_i_c, t_i_c = T(q_i_c), T(t_i_c)
    tex_img = torch.as_tensor(tex.image, device=device)
    tex_scale = tex.px_per_square / tex.square_length
    tex_offset = tex.margin_px - 0.5
    rng = np.random.default_rng(seed)
    rows = torch.arange(H, dtype=torch.float64, device=device)
    taps = ([0.0] if motion_blur_s <= 0 else
            [k * motion_blur_s / max(blur_taps - 1, 1) for k in range(blur_taps)])
    frames = []
    for t_stamp in np.asarray(frame_stamp_times, np.float64):
        acc = None
        for dt_tap in taps:
            qi, pi = pose_fn(t_stamp + time_offset + dt_tap + line_delay * rows)
            q_rows, p_rows = lie.se3_compose(qi, pi, q_i_c, t_i_c)
            img = _render_frame(cam, q_rows.to(dtype), p_rows.to(dtype), tex_img,
                                tex_scale, tex_offset, model_name, (W, H), supersample)
            acc = img if acc is None else acc + img
        img = acc.cpu().numpy().astype(np.float64) / len(taps)
        if exposure_flicker > 0:
            img = img * (1.0 + exposure_flicker * np.sin(2.0 * np.pi * flicker_hz * t_stamp))
        if noise_std > 0:
            img = img + rng.normal(0.0, noise_std, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames
