"""Entry ``batch``: the batch CLI's solve (``apps/batch_calibration.run``
after its front end): for each recording ``spline_estimator.build_problem``
and ``init_spline_params`` on the common knot spacings, then one
``batch_estimator.optimize_batch`` over all of them with the CLI's flags,
``LMConfig`` and chunk sizes. One item calibrates every recording of the
pool.

Set-up makes the recordings (one rig; each recording its own trajectory,
length and clock offset) and what the CLI's front end would hand the solve:
the corners, the poses (the scene's), the stage-7 start (the rig's truth
turned by ``init_rotation_rad``, moved by ``init_translation_m`` per axis,
the clock offset ``init_offset_s`` off) and the spline weighting ``sew``;
then one warm item.

Traffic keys: ``pool`` (trajectory seeds, the same for every run: the run's
seed draws the noise), ``durations_s``, ``offset_shifts_s`` (each
recording's clock offset from the configuration's), ``noise_px``, ``sew``,
``init_*``, ``mode``, ``max_iters``, ``ftol``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from benchmarks.entries.calibrate import gram_spy, noise_seeds
from benchmarks.gen import scene as sc
from benchmarks.harness import trace
from benchmarks.reference import calibration as ref


@dataclasses.dataclass
class Recording:
    scene: sc.Scene
    corners: object
    poses: object
    imu: object
    init_offset: float
    q_i_c0: np.ndarray
    t_i_c0: np.ndarray


@dataclasses.dataclass
class State:
    cell: object
    pool: list
    calib: object
    sew: object


def prepare(cell) -> State:
    """The cell's inputs, made from the seed (no warm item)."""
    from openimucameracalibrator_torch.utils.types import (CameraCalibration, CornerDataset,
                                                           ImuData, PoseDataset,
                                                           SplineWeightingData)

    c, t = cell.config, cell.traffic
    model = c["camera_model"].lower()
    pool = []
    for traj, dur, shift, ns in zip(t["pool"], t["durations_s"], t["offset_shifts_s"],
                                    noise_seeds(cell.seed, len(t["pool"]))):
        s = sc.make_imu_camera_scene(
            model, c["cam_params"], duration=dur, cam_fps=c["cam_fps"], imu_rate=c["imu_rate"],
            image_size=tuple(c["image_size"]), noise_px=t["noise_px"],
            time_offset=c["time_offset"] + shift, line_delay=c["line_delay"], seed=traj,
            noise_seed=ns, device=cell.device)
        q0 = sc.quat_multiply(torch.as_tensor(s.q_i_c), sc.so3_exp(
            torch.as_tensor(t["init_rotation_rad"], dtype=torch.float64))).numpy()
        pool.append(Recording(
            s, CornerDataset(s.frame_times, s.observations, s.obs_valid, s.board_points,
                             s.image_size, c["cam_fps"]),
            PoseDataset(s.frame_times, s.q_w_c, s.t_w_c, np.ones(len(s.frame_times), bool),
                        s.board_points),
            ImuData(s.imu_times, s.accel, s.gyro), s.time_offset + t["init_offset_s"], q0,
            np.asarray(s.t_i_c) + t["init_translation_m"]))
    calib = CameraCalibration(model, np.asarray(c["cam_params"], np.float64),
                              tuple(c["image_size"]), 0.0, fps=c["cam_fps"])
    state = State(cell, pool, calib, SplineWeightingData(cam_fps=c["cam_fps"], **t["sew"]))
    return state


def setup(cell) -> State:
    state = prepare(cell)
    for k in range(cell.traffic.get("warm_items", 1)):
        item(state, k)  # warm: loads the kernels, warms every stage at these shapes
    return state


def item(state, k: int) -> dict:
    """One batched solve of every recording of the pool, as the batch CLI
    runs it after its front end; per recording the CLI's answer."""
    with contextlib.ExitStack() as stack:
        for ctx in _variant(state):
            stack.enter_context(ctx)
        return _solve(state, state.pool)


def _solve(state, pool) -> dict:
    from openimucameracalibrator_torch.core import batch_estimator as be
    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.solver import lm
    from openimucameracalibrator_torch.utils import precision

    c, t = state.cell.config, state.cell.traffic
    device = precision.resolve_device(state.cell.device)
    dtype = precision.default_dtype(device)
    rolling = state.cell.variant != "gs"
    problems, inits = [], []
    for rec in pool:
        p = se.build_problem(rec.corners, state.calib, rec.imu, state.sew, rec.init_offset,
                             rolling, dtype=dtype, device=device)
        prm = se.init_spline_params(rec.poses, rec.q_i_c0, rec.t_i_c0, p, rec.imu,
                                    pose_time_offset=rec.init_offset, dtype=dtype,
                                    device=device)
        if rolling:
            prm["line_delay"] = torch.tensor([1.0 / c["cam_fps"] / c["image_size"][1]],
                                             dtype=dtype, device=device)
        problems.append(p)
        inits.append(prm)
    flags = se.DEFAULT_FLAGS | ({se.CAM_LINE_DELAY, se.TIME_OFFSET} if rolling
                                else {se.TIME_OFFSET})
    res = be.optimize_batch(problems, inits, flags=flags,
                            config=lm.LMConfig(max_iters=t["max_iters"], ftol=t["ftol"]),
                            mode=t["mode"])
    seqs = []
    for rec, p, prm in zip(pool, problems, res.params):
        seqs.append({"q_i_c": prm["q_i_c"].double().cpu().numpy(),
                     "t_i_c": prm["t_i_c"].double().cpu().numpy(),
                     "line_delay": float(prm["line_delay"][0]),
                     "time_offset": rec.init_offset + float(prm["time_offset"][0]),
                     "reproj_px": float(se.mean_reprojection_error(p, prm))})
    return {"sequences": seqs, "recordings": len(pool),
            "lm": {"iterations": int(np.sum(np.asarray(res.iterations))),
                   "seconds": float(res.seconds), "linearizations": int(res.linearizations)}}


def _variant(state) -> list:
    if not state.cell.variant:
        return []
    from benchmarks import faults

    return faults.batch(state)


def window(state, seconds: float) -> dict:
    answers, n = [], 0
    t0 = time.perf_counter()
    while n == 0 or time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        a = item(state, n)
        answers.append(a)
        print(f"item {n} {time.perf_counter() - t:.4f} s, lm iterations {a['lm']['iterations']}",
              file=sys.stderr, flush=True)
        n += 1
    elapsed = time.perf_counter() - t0
    recs = sum(a["recordings"] for a in answers)
    return {"answers": answers, "elapsed_s": elapsed, "attempted": recs,
            "metrics": {"calib_s": elapsed / recs}}


def reading(state) -> list:
    """One item: every recording of the pool once."""
    return [item(state, 0)]


def traced_item(state, k: int):
    from openimucameracalibrator_torch.core import batch_estimator, spline_estimator
    from openimucameracalibrator_torch.solver import gram

    calls = {"gram": []}
    with contextlib.ExitStack() as stack:
        stack.enter_context(trace.patched(spline_estimator, "build_problem",
                                          trace.spanned("batch.build_problem")))
        stack.enter_context(trace.patched(batch_estimator, "optimize_batch",
                                          trace.spanned("batch.optimize")))
        stack.enter_context(trace.patched(gram, "fused_gram", gram_spy(calls["gram"])))
        answer = item(state, k)
    return answer, calls


def check(state, answers) -> dict:
    worst = {}
    noise = state.cell.traffic["noise_px"]
    for a in answers:
        for rec, s in zip(state.pool, a["sequences"]):
            errs = ref.rig_errors(rec.scene, s["q_i_c"], s["t_i_c"], s["time_offset"],
                                  s["line_delay"], s["reproj_px"], noise)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, -np.inf), v)
    return worst


def release(state):
    state.pool.clear()
