"""The detect cell's comparison: the corners the program found against the
render's truth, which the benchmark works out itself from the trajectory it
rendered (``benchmarks/gen``): each charuco corner projected at the time its
row is read out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.gen import scene as sc


def truth_corners(pose_fn, model_name, cam_params, q_i_c, t_i_c, imu_times, line_delay,
                  image_size, device):
    """(uv (V, P, 2), visible (V, P)) of the board's charuco corners in each
    frame exposed at IMU times ``imu_times``."""
    T = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device)  # noqa: E731
    uv, valid, _ = sc.project_rows(pose_fn, model_name, T(cam_params), T(sc.charuco_points()),
                                   T(imu_times), T(q_i_c), T(t_i_c), line_delay, image_size)
    return uv.cpu().numpy(), valid.cpu().numpy()


def inside(uv, visible, image_size, margin: float):
    w, h = image_size
    return (visible & (uv[..., 0] >= margin) & (uv[..., 0] <= w - 1 - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] <= h - 1 - margin))


# A corner that lies well inside the image and was not found counts as this
# gap: a corner 2 px off is of as little use to the calibration as none.
MISSED_GAP_PX = 2.0


def corner_errors(points2d, valid, truth_uv, truth_visible, image_size, margin: float) -> dict:
    """Numbers over every frame of the window. ``corner_gap_px``, the one
    compared: the RMS gap from the truth over every corner found (at its
    id's truth) and every corner ``margin`` px or more inside the image that
    was not (at ``MISSED_GAP_PX``). Beside it, for the record, the RMS over
    the corners found and the share (%) of those due that were missed.

    ``points2d`` (V, P, 2) and ``valid`` (V, P) are the program's answer;
    ``truth_uv`` / ``truth_visible`` the truth of the same frames."""
    found = np.asarray(valid, bool)
    due = inside(truth_uv, truth_visible, image_size, margin)
    missed = due & ~found
    gap = np.linalg.norm(np.asarray(points2d, np.float64) - truth_uv, axis=-1)[found]
    if not found.any() or not np.all(np.isfinite(gap)):
        return {"corner_gap_px": math.inf, "corner_rms_px": math.inf, "missed_pct": 100.0}
    sq = float(np.sum(gap * gap)) + MISSED_GAP_PX ** 2 * int(missed.sum())
    return {"corner_gap_px": math.sqrt(sq / (gap.size + int(missed.sum()))),
            "corner_rms_px": float(np.sqrt(np.mean(gap * gap))),
            "missed_pct": 100.0 * float(missed.sum()) / max(int(due.sum()), 1)}
