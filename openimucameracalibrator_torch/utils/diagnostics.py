"""Diagnostics: spline-vs-IMU plots, PLY exports, reprojection overlays.

Port of ``utils/diagnostics.py`` of the JAX package, the reference's visual
verification tooling (SURVEY.md §4.3):
* spline-vs-IMU + bias-evolution plots (python/print_result_stats.py:24-95),
* PLY point-cloud exports of board points and camera positions
  (src/core/camera_calibrator.cc:342-345, 381-384),
* debug reprojection overlay video
  (applications/continuous_time_imu_to_camera_calibration.cc:366-454),
* an accuracy study of an onboard orientation stream (GoPro CORI).

matplotlib (plots) and cv2 (the overlay video) are imported when a
function needs them, and the error names the missing one. The spline
evaluations run on the device of the problem's tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or an ImportError naming
    matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x):
    return x.detach().cpu().numpy()


def plot_spline_vs_imu(problem, params, path: str, stride: int = 5):
    """Predicted vs measured accel/gyro + bias splines -> one PNG."""
    plt = pyplot()
    from openimucameracalibrator_torch.core import spline_estimator as se

    t_all = problem.accel_t[::stride]
    ok = se._in_range(problem, t_all)
    t = t_all[ok]
    acc_spline, gyro_spline, ba, bg = se.evaluate_imu_components(problem, params, t)
    acc_pred, gyro_pred = _host(acc_spline + ba), _host(gyro_spline + bg)
    acc_meas = _host(problem.accel_meas[::stride][ok])
    gyro_meas = _host(problem.gyro_meas[::stride][ok])
    t = _host(t)
    fig, axes = plt.subplots(4, 1, figsize=(12, 14), sharex=True)
    for k, lbl in enumerate("xyz"):
        axes[0].plot(t, acc_meas[:, k], ".", ms=1, alpha=0.4)
        axes[0].plot(t, acc_pred[:, k], label=f"spline {lbl}")
        axes[1].plot(t, gyro_meas[:, k], ".", ms=1, alpha=0.4)
        axes[1].plot(t, gyro_pred[:, k], label=f"spline {lbl}")
    axes[0].set_ylabel("accel m/s²")
    axes[0].legend()
    axes[1].set_ylabel("gyro rad/s")
    axes[1].legend()
    axes[2].plot(t, _host(ba))
    axes[2].set_ylabel("accel bias")
    axes[3].plot(t, _host(bg))
    axes[3].set_ylabel("gyro bias")
    axes[3].set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_result_stats(result_json_path: str, out_path: str):
    """Spline-vs-IMU + bias-evolution plots from the RESULT ARTIFACT ALONE.

    Offline equivalent of the reference's python/print_result_stats.py:24-95:
    it reads only the result json's per-sample ``trajectory`` block (written
    by io.save_imu_camera_result, reference schema
    continuous_time_imu_to_camera_calibration.cc:273-332) -- no problem or
    parameter state is needed, so reference-produced result files replot
    identically. Returns the PNG path."""
    import json

    plt = pyplot()
    with open(result_json_path) as f:
        obj = json.load(f)
    traj = obj.get("trajectory")
    if not traj:
        raise ValueError(f"{result_json_path} has no 'trajectory' block")

    def series(kind):
        rows = sorted((int(t_ns), e[kind]) for t_ns, e in traj.items() if kind in e)
        t = np.asarray([r[0] for r in rows], np.float64) * 1e-9
        v = np.asarray([[r[1][a] for a in "xyz"] for r in rows])
        return t, v

    fig, axes = plt.subplots(4, 1, figsize=(12, 14), sharex=True)
    for row, sensor, unit in ((0, "accl", "accel m/s²"), (1, "gyro", "gyro rad/s")):
        tm, vm = series(f"{sensor}_imu")
        ts, vs = series(f"{sensor}_spline")
        _, vb = series(f"{sensor}_bias")
        for k, lbl in enumerate("xyz"):
            axes[row].plot(tm, vm[:, k], ".", ms=1, alpha=0.4)
            axes[row].plot(ts, vs[:, k] + vb[:, k], label=f"spline {lbl}")
        axes[row].set_ylabel(unit)
        axes[row].legend()
        axes[row + 2].plot(ts, vb)
        axes[row + 2].set_ylabel(f"{sensor} bias")
    axes[3].set_xlabel("time (s)")
    err = obj.get("final_reproj_error")
    if err is not None:
        axes[0].set_title(f"final mean reprojection error: {err:.3f} px")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def export_ply(points: np.ndarray, path: str, colors: np.ndarray | None = None):
    """ASCII PLY point cloud (Theia WritePlyFile equivalent)."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")
    return path


def export_calibration_ply(details: dict, board_points: np.ndarray, path: str):
    """Board points (red) + camera positions (green), like the reference's
    per-stage ply dumps."""
    from openimucameracalibrator_torch.ops import lie

    _, cams = lie.se3_inverse(torch.as_tensor(np.asarray(details["q_cw"], np.float64)),
                              torch.as_tensor(np.asarray(details["t_cw"], np.float64)))
    cams = cams.numpy()
    pts = np.concatenate([board_points, cams])
    colors = np.concatenate([np.tile([255, 0, 0], (len(board_points), 1)),
                             np.tile([0, 255, 0], (len(cams), 1))])
    return export_ply(pts, path, colors)


def reprojection_overlay_video(video_path: str, out_path: str, problem, params,
                               corners, time_offset: float, max_frames: int = 0):
    """Draw measured (green) vs spline-reprojected (red) corners on the
    input video (continuous_time...cc:366-454)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the reprojection overlay video needs cv2 (opencv-python), "
                          "which is not installed") from e
    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.models import cameras as cam_mod
    from openimucameracalibrator_torch.ops import lie

    model = cam_mod.get_model(problem.model_name)
    dt, dev = problem.cam_params.dtype, problem.cam_params.device
    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    frame_times = corners.times + time_offset
    board = torch.as_tensor(np.asarray(corners.board_points), dtype=dt, device=dev)
    n = len(frame_times) if not max_frames else min(max_frames, len(frame_times))
    q_i_c, t_i_c = params["q_i_c"], params["t_i_c"]
    for v in range(n):
        okf, frame = cap.read()
        if not okf:
            break
        qs, ts = se.evaluate_pose(problem, params,
                                  torch.tensor([frame_times[v]], dtype=dt, device=dev))
        q_wc, t_wc = lie.se3_compose(qs[0], ts[0], q_i_c, t_i_c)
        q_cw, t_cw = lie.se3_inverse(q_wc, t_wc)
        uv, okp = model.project(problem.cam_params, lie.se3_act(q_cw, t_cw, board))
        uv, okp = _host(uv), _host(okp)
        for k in range(board.shape[0]):
            if corners.valid[v, k]:
                cv2.circle(frame, tuple(int(c) for c in corners.points2d[v, k]), 3,
                           (0, 255, 0), -1)
            if okp[k]:
                cv2.circle(frame, tuple(int(c) for c in uv[k]), 2, (0, 0, 255), -1)
        writer.write(frame)
    writer.release()
    cap.release()
    return out_path


def evaluate_camera_orientation_stream(cam_quats: np.ndarray, cam_times: np.ndarray,
                                       poses) -> dict:
    """Accuracy study of an onboard orientation stream (e.g. GoPro CORI)
    against visually estimated poses (python/evaluate_cori_and_iori_quats.py
    equivalent), on the host in float64.

    Aligns the two orientation streams by the best-fit constant rotations
    on both sides (q_vis ~= a * q_stream * b) estimated from the first
    valid samples, then reports residual angle statistics in degrees.
    """
    from openimucameracalibrator_torch.ops import interpolation, lie

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float64))

    ok = poses.valid
    vis_t = T(poses.times[ok])
    q_vis = T(poses.q_w_c[ok])
    qn = np.array(cam_quats, np.float64)
    for k in range(1, qn.shape[0]):
        if np.dot(qn[k], qn[k - 1]) < 0:
            qn[k] = -qn[k]
    q_stream = interpolation.interp_quaternion(T(cam_times), T(qn), vis_t)
    # Compare delta rotations, which cancel both fixed offsets up to
    # conjugation; then the best-fit conjugating rotation between their axes.
    d_vis = lie.quat_multiply(lie.quat_conjugate(q_vis[:-1]), q_vis[1:])
    d_str = lie.quat_multiply(lie.quat_conjugate(q_stream[:-1]), q_stream[1:])
    v1 = lie.so3_log(d_vis).numpy()
    v2 = lie.so3_log(d_str).numpy()
    W = v2.T @ v1
    U, _, Vt = np.linalg.svd(W)
    R = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
    resid = v1 - v2 @ R
    ang_err = np.rad2deg(np.linalg.norm(resid, axis=1))
    mag = np.rad2deg(np.linalg.norm(v1, axis=1))
    return {
        "median_delta_angle_error_deg": float(np.median(ang_err)),
        "p90_delta_angle_error_deg": float(np.percentile(ang_err, 90)),
        "median_delta_magnitude_deg": float(np.median(mag)),
        "alignment_rotation": R,
    }
