"""Entry ``detect``: charuco detection (``core/board_extractor.extract_board``
with the native backend and its batched video path) over a stream of
(time, gray u8) frames.

Set-up renders a pool of frames of the configuration's camera along the
trajectory of a GoPro recording (rolling shutter, sensor noise drawn from the
seed on the card) and works out each frame's corner truth, then warms the
detector on two blocks. The window feeds the pool, cycled with rising
timestamps at the camera's rate, until its time runs out; the pipeline then
drains. Every frame that reached the host is held against its truth.

Traffic keys: ``trajectory`` (seed of the trajectory, the same for every
run: the run's seed draws the noise), ``pool_frames``, ``noise_dn``,
``supersample``, ``texture_px_per_square``, ``texture_margin_px``,
``batch_frames``, ``truth_margin_px``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from benchmarks.gen import frames as fr, scene as sc
from benchmarks.harness import trace
from benchmarks.reference import corners as ref


@dataclasses.dataclass
class State:
    cell: object
    pool: list            # host uint8 frames
    truth_uv: np.ndarray  # (n, P, 2)
    truth_vis: np.ndarray
    fps: float
    opts: object


def prepare(cell) -> State:
    """The cell's inputs, made from the seed (no warm pass)."""
    from openimucameracalibrator_torch.core import board_extractor

    c, t = cell.config, cell.traffic
    model = c["camera_model"].lower()
    fps, n = c["cam_fps"], t["pool_frames"]
    q_i_c = sc.rig_rotation(cell.device).cpu().numpy()
    # The recording trajectory of the port's GoPro-path generator
    # (utils/recorded.make_recording): the camera 0.46 m in front of the
    # board's centre, facing it.
    pose_fn = sc.sinusoid_trajectory(
        np.random.default_rng(t["trajectory"]), rot_amp=0.22, pos_amp=0.08,
        pos_center=(0.2, 0.16, -0.46), q_base=sc.quat_conjugate(torch.as_tensor(q_i_c)).numpy(),
        device=cell.device)
    t_i_c = np.asarray(c["assumed"]["t_i_c_m"], np.float64)
    imu_times = np.arange(n) / fps + 0.5 / fps
    tex = fr.charuco_texture(px_per_square=t["texture_px_per_square"],
                             margin_px=t["texture_margin_px"])
    frames = fr.render_frames(pose_fn, imu_times - c["time_offset"], model, c["cam_params"],
                              q_i_c, t_i_c, tex, tuple(c["image_size"]),
                              time_offset=c["time_offset"], line_delay=c["line_delay"],
                              supersample=t["supersample"], noise_std=t["noise_dn"],
                              seed=cell.seed, device=cell.device)
    pool = list(frames.cpu().numpy())
    del frames
    uv, vis = ref.truth_corners(pose_fn, model, c["cam_params"], q_i_c, t_i_c, imu_times,
                                c["line_delay"], tuple(c["image_size"]), cell.device)
    opts = board_extractor.BoardExtractorOptions(board_type="charuco",
                                                 batch_frames=t["batch_frames"])
    return State(cell, pool, uv, vis, fps, opts)


def setup(cell) -> State:
    state = prepare(cell)
    _extract(state, _stream(state, 0, 2 * cell.traffic["batch_frames"]))  # warm
    return state


def _stream(state, start: int, count: int | None, stop_at: float | None = None):
    """(t, frame) of pool frames start, start+1, ... (cycled), stamped at the
    camera's rate; ``count`` frames, or one block and then more until the
    host clock reads ``stop_at``."""
    n, block = len(state.pool), state.opts.batch_frames
    i = start
    while (count is None or i < start + count) and (
            stop_at is None or i < start + block or time.perf_counter() < stop_at):
        yield i / state.fps, state.pool[i % n]
        i += 1


def _extract(state, frames):
    from openimucameracalibrator_torch.core import board_extractor

    with contextlib.ExitStack() as stack:
        for ctx in _variant(state):
            stack.enter_context(ctx)
        return board_extractor.extract_board(frames, state.opts, fps=state.fps,
                                             device=state.cell.device)


def _variant(state) -> list:
    if not state.cell.variant:
        return []
    from benchmarks import faults

    return faults.detect(state)


def window(state, seconds: float) -> dict:
    t0 = time.perf_counter()
    ds = _extract(state, _stream(state, 0, None, stop_at=t0 + seconds))
    elapsed = time.perf_counter() - t0
    return {"answers": [ds], "elapsed_s": elapsed, "attempted": int(ds.num_views),
            "metrics": {"detect_fps": ds.num_views / elapsed}}


def reading(state) -> list:
    """Answers over every frame of the pool once (a window cycles the same
    frames, noise and all)."""
    return [_extract(state, _stream(state, 0, len(state.pool)))]


def traced_item(state, k: int):
    """One pass over the pool with spans around the detector's stages and
    the shapes of every K2 block call."""
    from openimucameracalibrator_torch.detect import kernels, video

    calls = {"k2_block": []}

    def k2_spy(real):
        def wrapper(imgs, *a, **kw):
            calls["k2_block"].append(tuple(imgs.shape))
            return real(imgs, *a, **kw)
        return wrapper

    with contextlib.ExitStack() as stack:
        for name, label in (("_stage_pixels", "detect.pixels"), ("_host_quads", "detect.quads"),
                            ("_stage_decode_interp", "detect.decode")):
            stack.enter_context(trace.patched(video, name, trace.spanned(label)))
        stack.enter_context(trace.patched(kernels, "corner_response_block", k2_spy))
        ds = _extract(state, _stream(state, 0, len(state.pool)))
    return ds, calls


def check(state, answers) -> dict:
    n = len(state.pool)
    pts, val, uv, vis = [], [], [], []
    for ds in answers:
        idx = np.rint(np.asarray(ds.times) * state.fps).astype(np.int64) % n
        pts.append(ds.points2d)
        val.append(ds.valid)
        uv.append(state.truth_uv[idx])
        vis.append(state.truth_vis[idx])
    return ref.corner_errors(np.concatenate(pts), np.concatenate(val), np.concatenate(uv),
                             np.concatenate(vis), tuple(state.cell.config["image_size"]),
                             state.cell.traffic["truth_margin_px"])


def release(state):
    state.pool.clear()
