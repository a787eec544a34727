"""Recorded-data harness: render full video frames from a ground-truth
trajectory and mux them with matching GPMF telemetry into GoPro-style MP4s.

Port of ``utils/recorded.py`` of the JAX package. The end-to-end pipeline
(video decode, corner detection on rendered sensor imagery, GPMF
telemetry extraction, every calibration stage) runs from MP4 files alone,
and every recovered parameter has a known ground truth to assert against.
Frame synthesis is inverse-mapped and rolling-shutter exact: each output
pixel row r is rendered from the camera pose at t_frame + line_delay * r,
the pixel ray is unprojected through the true camera model (distortion
included), intersected with the board plane z = 0, and the board texture
is sampled bilinearly with supersampled anti-aliasing. The frames render
on the device; the degradations (flicker, sensor noise) are applied on the
host from ``np.random.default_rng(seed)``, draw for draw as in the JAX
package, so the same poses give the same frames.

``make_recording`` seeds its random streams as the JAX package seeds its
keys: the intrinsics trajectory from ``seed``, the imu-cam trajectory
from ``seed + 1`` (``numpy.random.Generator``s, as
``synthetic.sinusoid_trajectory`` takes them), the imu-cam render noise
from ``seed + 2`` and the IMU noise from a ``torch.Generator`` seeded
``seed + 3``. The draws differ from ``jax.random``'s, so the same seed
gives another trajectory than the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from openimucameracalibrator_torch.detect import aruco_dict, render
from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.ops import lie
from openimucameracalibrator_torch.utils import mp4_writer, precision, synthetic


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


@dataclasses.dataclass
class Recording:
    """Paths + ground truth of one synthetic recorded dataset."""

    cam_video: str
    imu_cam_video: str
    cam_params: np.ndarray
    model_name: str
    image_size: tuple
    q_i_c: np.ndarray
    t_i_c: np.ndarray
    time_offset: float
    line_delay: float
    accel_bias: np.ndarray
    gyro_bias: np.ndarray
    pose_fn: object
    cam_fps: float
    imu_rate: float


def make_recording(outdir: str, *, model_name: str = "division_undistortion",
                   cam_params=None, image_size=(640, 360),
                   duration: float = 14.0, cam_fps: float = 10.0,
                   intrinsics_frames: int = 25, imu_rate: float = 200.0,
                   time_offset: float = -0.08, line_delay: float = 0.0,
                   squares_x: int = 8, squares_y: int = 6,
                   square_length: float = 0.06, marker_length: float = 0.045,
                   accel_noise: float = 0.015, gyro_noise: float = 0.0012,
                   accel_bias=(0.05, -0.03, 0.08),
                   gyro_bias=(0.004, -0.002, 0.003),
                   supersample: int = 2, seed: int = 3,
                   imu_cam: bool = True,
                   noise_std: float = 1.5, motion_blur_s: float = 0.0,
                   exposure_flicker: float = 0.0,
                   jpeg_quality: int = 92, device=None, dtype=None) -> Recording:
    """Render + mux a complete two-video dataset (intrinsics video without
    telemetry; imu-cam video with an ACCL/GYRO/CORI GPMF track). Frames
    render on ``device`` (default ``"cuda"``; float64 on the CPU, float32
    on the card); trajectory and IMU readings are float64.

    ``imu_cam=False`` renders only the intrinsics video (for
    intrinsics-only fixtures)."""
    device = precision.resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    W, H = image_size
    model = cameras.get_model(model_name)
    if cam_params is None:
        # GoPro9-like wide intrinsics scaled to the render resolution
        # (BASELINE.md rows 1/3), principal point near the image center.
        sc = W / 960.0
        cam_params = {
            "division_undistortion": [437.13 * sc, W / 2 + 9 * sc, H / 2 + 1 * sc,
                                      -1.4386e-06 / (sc * sc)],
            "pinhole": [437.13 * sc, 437.13 * sc, W / 2 + 9 * sc, H / 2 + 1 * sc],
            # BASELINE.md row 3 (GoPro9 fisheye / Kannala-Brandt)
            "fisheye": [435.45 * sc, 435.45 * sc, W / 2 - 0.9 * sc, H / 2 + 4.5 * sc,
                        0.05, 0.07, -0.11, 0.05],
        }.get(model_name)
        if cam_params is None:
            raise ValueError(f"no default params for {model_name}")
    cam_params = np.asarray(cam_params, np.float64)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    q_i_c = lie.so3_exp(torch.tensor([0.03, -0.02, np.pi / 2], dtype=torch.float64)).numpy()
    t_i_c = np.asarray([0.01, -0.02, 0.001])
    tex = charuco_texture(squares_x, squares_y, square_length, marker_length)

    # Camera on the -z side looking along +z: the OpenCV board convention
    # (board x right, y down, z away from the viewer) -- the rendered target
    # reads exactly as printed, no mirror (see sinusoid_trajectory q_base).
    board_ctr = (squares_x * square_length / 2, squares_y * square_length / 2)
    q_front = np.array([1.0, 0.0, 0.0, 0.0])

    # --- intrinsics video: slow sweep over a second trajectory ---
    pose_cam = synthetic.sinusoid_trajectory(
        np.random.default_rng(seed), duration=float(intrinsics_frames),
        pos_center=(board_ctr[0], board_ctr[1], -0.46), pos_amp=0.1,
        rot_amp=0.3, base_freq=0.1, q_base=q_front, device=device)
    t_cam_frames = np.linspace(0.0, 0.9 / 0.1, intrinsics_frames)
    degrade = dict(noise_std=noise_std, motion_blur_s=motion_blur_s,
                   exposure_flicker=exposure_flicker, supersample=supersample,
                   device=device, dtype=dtype)
    frames_cam = render_frames(pose_cam, t_cam_frames, model.name, cam_params,
                               np.array([1.0, 0, 0, 0]), np.zeros(3), tex, image_size,
                               seed=seed, **degrade)
    cam_path = os.path.join(outdir, "cam.MP4")
    fps_cam = 2.0  # slow sweep; only pose diversity matters here
    mp4_writer.write_mp4(cam_path, [mp4_writer.encode_jpeg(f, quality=jpeg_quality)
                                    for f in frames_cam], W, H, fps_cam)
    truth = dict(cam_params=cam_params, model_name=model.name, image_size=tuple(image_size),
                 q_i_c=q_i_c, t_i_c=t_i_c, time_offset=time_offset, line_delay=line_delay,
                 accel_bias=np.asarray(accel_bias, np.float64),
                 gyro_bias=np.asarray(gyro_bias, np.float64), cam_fps=cam_fps,
                 imu_rate=imu_rate)
    if not imu_cam:
        return Recording(cam_video=cam_path, imu_cam_video="", pose_fn=None, **truth)

    # --- imu-cam video: dynamic trajectory + GPMF telemetry ---
    # Body = IMU; base orientation chosen so the CAMERA (body * T_i_c)
    # faces the board front: q_wi_base = q_i_c^-1.
    q_imu_base = lie.quat_conjugate(torch.as_tensor(q_i_c)).numpy()
    pose_imu = synthetic.sinusoid_trajectory(
        np.random.default_rng(seed + 1), duration, rot_amp=0.22, pos_amp=0.08,
        pos_center=(board_ctr[0], board_ctr[1], -0.46), base_freq=0.4,
        q_base=q_imu_base, device=device)
    frame_stamps = np.arange(int(duration * cam_fps) - 1) / cam_fps
    frames_ic = render_frames(pose_imu, frame_stamps, model.name, cam_params, q_i_c, t_i_c,
                              tex, image_size, time_offset=time_offset,
                              line_delay=line_delay, seed=seed + 2, **degrade)

    imu_times = np.arange(0.0, duration, 1.0 / imu_rate)
    q, _, omega, _, acc = synthetic.pose_derivatives(pose_imu, T(imu_times))
    g_w = T([0.0, 0.0, synthetic.GRAVITY])
    f_b = lie.quat_rotate(lie.quat_conjugate(q), acc + g_w).cpu()
    gen = torch.Generator().manual_seed(seed + 3)
    noise_a = torch.randn(f_b.shape, generator=gen, dtype=torch.float64)
    noise_g = torch.randn(f_b.shape, generator=gen, dtype=torch.float64)
    accel = (f_b + torch.as_tensor(truth["accel_bias"]) + accel_noise * noise_a).numpy()
    gyro = (omega.cpu() + torch.as_tensor(truth["gyro_bias"]) + gyro_noise * noise_g).numpy()
    payloads, dur = mp4_writer.make_imu_payloads(
        imu_times, accel, gyro, cam_quats=q.cpu().numpy(), cam_quat_times=imu_times)
    ic_path = os.path.join(outdir, "imu_cam.MP4")
    mp4_writer.write_mp4(ic_path, [mp4_writer.encode_jpeg(f, quality=jpeg_quality)
                                   for f in frames_ic], W, H, cam_fps, payloads, dur)
    return Recording(cam_video=cam_path, imu_cam_video=ic_path, pose_fn=pose_imu, **truth)
