"""Entry ``calibrate``: the pipeline CLI (``apps/run_calibration.run``) on
its resume path, one recording per item.

Set-up makes a pool of recordings (each: the imu-cam corners of a rolling-
shutter recording, the intrinsics corners and the generic telemetry json,
written in the users' formats) and runs one warm item. The window runs items
back to back, cycling the pool; the item in flight when the window's time
runs out is finished. Each item gets a fresh workspace holding only the two
corner files, deleted after the item (a reused one would resume stage 8
from the last item's solver checkpoint).

Traffic keys: ``pool`` (trajectory seeds of the recordings, the same for
every run: the run's seed draws the noise and the order), ``duration_s``,
``intrinsics_views``, ``noise_px``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmarks.gen import files, scene as sc
from benchmarks.harness import trace
from benchmarks.reference import calibration as ref


@dataclasses.dataclass
class Recording:
    dir: str
    imu_cam: sc.Scene
    intrinsics: sc.Scene


@dataclasses.dataclass
class State:
    cell: object
    root: str
    pool: list
    model_arg: str


def noise_seeds(seed: int, n: int) -> list:
    """Distinct noise seeds for ``n`` recordings, from the run's seed."""
    ss = np.random.SeedSequence(int(seed) % 2**63).spawn(n)
    return [int(s.generate_state(1, np.uint64)[0] >> 1) for s in ss]


def pool_order(seed: int, n: int) -> list:
    return [int(i) for i in np.random.default_rng(int(seed) % 2**63 + 1).permutation(n)]


def make_recording(cell, traj_seed: int, noise_seed: int, out_dir: str) -> Recording:
    c, t = cell.config, cell.traffic
    model = c["camera_model"].lower()
    imu_cam = sc.make_imu_camera_scene(
        model, c["cam_params"], duration=t["duration_s"], cam_fps=c["cam_fps"],
        imu_rate=c["imu_rate"], image_size=tuple(c["image_size"]), noise_px=t["noise_px"],
        time_offset=c["time_offset"], line_delay=c["line_delay"], seed=traj_seed,
        noise_seed=noise_seed, device=cell.device)
    intr = sc.make_intrinsics_scene(
        model, c["cam_params"], num_views=t["intrinsics_views"],
        image_size=tuple(c["image_size"]), noise_px=t["noise_px"], seed=traj_seed + 1000,
        noise_seed=noise_seed + 1, device=cell.device)
    os.makedirs(out_dir)
    files.write_corners(os.path.join(out_dir, "imu_cam_corners.uson"), imu_cam.frame_times,
                        imu_cam.observations, imu_cam.obs_valid, imu_cam.board_points,
                        imu_cam.image_size, c["cam_fps"])
    files.write_corners(os.path.join(out_dir, "cam_corners.uson"), intr.frame_times,
                        intr.observations, intr.obs_valid, intr.board_points, intr.image_size,
                        c["cam_fps"])
    files.write_generic_telemetry(os.path.join(out_dir, "telemetry.json"), imu_cam.imu_times,
                                  imu_cam.accel, imu_cam.gyro, c["cam_fps"])
    return Recording(out_dir, imu_cam, intr)


def prepare(cell) -> State:
    """The cell's inputs, made from the seed (no warm item)."""
    t = cell.traffic
    root = tempfile.mkdtemp(prefix="bench_calibrate_")
    seeds = noise_seeds(cell.seed, len(t["pool"]))
    pool = [make_recording(cell, traj, ns, os.path.join(root, f"rec{k}"))
            for k, (traj, ns) in enumerate(zip(t["pool"], seeds))]
    order = pool_order(cell.seed, len(pool))
    state = State(cell, root, [pool[k] for k in order], cell.config["camera_model"])
    return state


def setup(cell) -> State:
    state = prepare(cell)
    for k in range(cell.traffic.get("warm_items", 1)):
        item(state, k)  # warm: loads the kernels, warms every stage at these shapes
    return state


def _argv(state, rec, ws, extra):
    return ["--path_calib_dataset", rec.dir, "--telemetry_json",
            os.path.join(rec.dir, "telemetry.json"), "--telemetry_format", "generic",
            "--camera_model", state.model_arg, "--workspace", ws, "--device", state.cell.device,
            *extra]


def item(state, k: int) -> dict:
    """Calibrate recording ``k`` of the pool (cycled) in a fresh workspace;
    the answer (summary, stage-8 result) and the program's spans."""
    from openimucameracalibrator_torch.apps import run_calibration
    from openimucameracalibrator_torch.core import imu_camera_calibrator as icc

    rec = state.pool[k % len(state.pool)]
    ws = tempfile.mkdtemp(dir=state.root, prefix="ws_")
    try:
        for f in ("cam_corners.uson", "imu_cam_corners.uson"):
            _link(os.path.join(rec.dir, f), os.path.join(ws, f))
        caught = {}

        def catch(real):
            def wrapper(*a, **kw):
                caught["result"] = real(*a, **kw)
                return caught["result"]
            return wrapper

        patches, extra = _variant(state)
        with contextlib.ExitStack() as stack:
            stack.enter_context(trace.patched(icc, "calibrate_imu_camera", catch))
            for ctx in patches:
                stack.enter_context(ctx)
            summary = run_calibration.run(run_calibration.build_parser().parse_args(
                _argv(state, rec, ws, extra)))
        res = caught["result"]
        return {"recording": k % len(state.pool), "summary": summary,
                "bias_a": res.params["bias_a"].double().mean(0).cpu().numpy(),
                "bias_g": res.params["bias_g"].double().mean(0).cpu().numpy(),
                "lm_stages": res.stages, "recordings": 1}
    finally:
        shutil.rmtree(ws, ignore_errors=True)


def _link(src, dst):
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy(src, dst)


def _variant(state):
    """(context managers, extra flags) that put a control or a planted fault
    under the item; none for the program as it ships (``benchmarks/faults.py``)."""
    if not state.cell.variant:
        return [], []
    from benchmarks import faults

    return faults.calibrate(state.cell.variant)


def window(state, seconds: float) -> dict:
    """Items back to back while ``seconds`` last (at least one); the last one
    finishes."""
    answers, n = [], 0
    t0 = time.perf_counter()
    while n == 0 or time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        a = item(state, n)
        answers.append(a)
        iters = sum(s["iterations"] for s in a["lm_stages"])
        print(f"item {n} {time.perf_counter() - t:.4f} s, lm iterations {iters}",
              file=sys.stderr, flush=True)
        n += 1
    elapsed = time.perf_counter() - t0
    recs = sum(a["recordings"] for a in answers)
    return {"answers": answers, "elapsed_s": elapsed, "attempted": recs,
            "metrics": {"calib_s": elapsed / recs}}


def reading(state) -> list:
    """Answers for every recording of the pool once."""
    return [item(state, k) for k in range(len(state.pool))]


def traced_item(state, k: int):
    """One item with the harness's spans around the program's layers, and the
    shapes of every K1 call."""
    from openimucameracalibrator_torch.core import (camera_calibrator, imu_cam_rotation,
                                                    imu_camera_calibrator, pose_estimator)
    from openimucameracalibrator_torch.solver import gram
    from openimucameracalibrator_torch.utils import io

    calls = {"gram": []}
    with contextlib.ExitStack() as stack:
        for mod, name, label in ((io, "load_corners", "corner_io"),
                                 (camera_calibrator, "calibrate_camera", "stage1"),
                                 (pose_estimator, "estimate_poses", "stage5"),
                                 (imu_cam_rotation, "estimate_imu_to_camera_rotation", "stage7"),
                                 (imu_camera_calibrator, "calibrate_imu_camera", "stage8")):
            stack.enter_context(trace.patched(mod, name, trace.spanned(label)))
        stack.enter_context(trace.patched(gram, "fused_gram", gram_spy(calls["gram"])))
        answer = item(state, k)
    return answer, calls


def gram_spy(records):
    def factory(real):
        def wrapper(J, r, idx, segments, L, *a, **kw):
            K, R, F = J.shape
            records.append((K, R, F, int(L), sum(1 for s in segments if s[0] == "run")))
            return real(J, r, idx, segments, L, *a, **kw)
        return wrapper
    return factory


def check(state, answers) -> dict:
    """The worst of each compared number over every item's answer."""
    worst = {}
    for a in answers:
        rec = state.pool[a["recording"]]
        for k, v in ref.calibration_errors(state.cell.config, state.cell.traffic, rec.imu_cam,
                                           a).items():
            worst[k] = max(worst.get(k, -np.inf), v)
    return worst


def release(state):
    shutil.rmtree(state.root, ignore_errors=True)
