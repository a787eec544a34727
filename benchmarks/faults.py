"""Controls and planted faults, for the readings that set each limit
(``benchmarks/readings.py``) and for the tests that see ``correct`` come out
false (``benchmarks/tests/``). The benchmark's own runs never use them.

Variants:

* ``gs`` (the control of the calibrate and batch cells): the rig's rolling
  shutter, which the configuration states, left unmodelled.
* ``tf32``: the program with TF32 products switched on (the port runs
  float32 with TF32 off), a witness reading beside the control.
* ``frozen``: every Levenberg-Marquardt solve returns its start unchanged.
* ``altered``: the stage-8 clock offset altered by one IMU sample (5 ms)
  where it is produced; in detection, two corner ids swapped in each frame.
* ``intrinsics``: stage 1's answer, the camera's focal lengths and
  principal point, made 2 % too large where it is produced; stages 5-8
  then work from it.
* ``ld_fixed``: stage 8 (and the batch solve) left with the line delay
  unfitted, at its start of one frame time over the image rows, while the
  rolling shutter stays modelled.
* ``half``: half of the batch left out: the batch solve sees only its first
  half of the recordings and answers for the rest with theirs; detection
  returns no corners for the second half of each block of frames.
* ``rounded`` (the control of the detect cell): the render's truth put in
  the program's place with its positions on whole pixels, breaking the
  sub-pixel positions the configuration states.
"""

from __future__ import annotations

import contextlib

import torch

from benchmarks.harness import trace

CALIBRATE = ("gs", "tf32", "frozen", "altered", "intrinsics", "ld_fixed")
DETECT = ("rounded", "frozen", "altered", "half")
BATCH = ("gs", "tf32", "frozen", "altered", "half", "ld_fixed")


@contextlib.contextmanager
def tf32():
    from openimucameracalibrator_torch.utils import precision

    def factory(real):
        def wrapper(*a, **kw):
            dev = real(*a, **kw)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            return dev
        return wrapper

    with trace.patched(precision, "resolve_device", factory):
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def frozen_lm():
    """LM returns its initial parameters: a step that leaves its state as it
    found it."""
    from openimucameracalibrator_torch.solver import lm

    def single(real):
        def wrapper(linearize_fn, cost_fn, retract_fn, params0, free_mask, config=lm.LMConfig(),
                    **kw):
            c = cost_fn(params0)
            return lm.LMResult(params=params0, cost=c, iterations=0, lam=torch.zeros(()),
                               converged=False, cost_history=torch.full((64,), float("nan")))
        return wrapper

    def lanes(real):
        def wrapper(linearize_fn, cost_fn, retract_fn, params0, free_mask, config=lm.LMConfig(),
                    **kw):
            c = cost_fn(params0)
            n = c.shape[0]
            return lm.LMResult(params=params0, cost=c, iterations=torch.zeros(n, dtype=torch.long),
                               lam=torch.zeros(n), converged=torch.zeros(n, dtype=torch.bool),
                               status=torch.zeros(n, dtype=torch.long),
                               cost_history=torch.full((n, 64), float("nan")))
        return wrapper

    with trace.patched(lm, "lm_optimize", single), trace.patched(lm, "lm_optimize_lanes", lanes):
        yield


@contextlib.contextmanager
def altered_offset():
    from openimucameracalibrator_torch.core import imu_camera_calibrator as icc

    def factory(real):
        def wrapper(*a, **kw):
            res = real(*a, **kw)
            res.time_offset += 0.005
            return res
        return wrapper

    with trace.patched(icc, "calibrate_imu_camera", factory):
        yield


@contextlib.contextmanager
def offset_intrinsics():
    """Stage 1 answers with its focal lengths and principal point (the
    first three parameters of either model) 2 % too large."""
    import dataclasses

    import numpy as np

    from openimucameracalibrator_torch.core import camera_calibrator

    def factory(real):
        def wrapper(*a, **kw):
            calib, rest = real(*a, **kw)
            params = np.array(calib.params, dtype=np.float64)
            params[:3] *= 1.02
            return dataclasses.replace(calib, params=params), rest
        return wrapper

    with trace.patched(camera_calibrator, "calibrate_camera", factory):
        yield


def _without_line_delay(flags):
    from openimucameracalibrator_torch.core import spline_estimator as se

    return frozenset(flags) - {se.CAM_LINE_DELAY}


@contextlib.contextmanager
def line_delay_unfitted():
    """Stage 8's schedule without the line delay among its free blocks."""
    from openimucameracalibrator_torch.core import spline_estimator as se

    def factory(real):
        def wrapper(p, params0, stages, *a, **kw):
            return real(p, params0, [(_without_line_delay(f), n) for f, n in stages], *a, **kw)
        return wrapper

    with trace.patched(se, "optimize_stages", factory):
        yield


def calibrate(variant: str) -> tuple[list, list]:
    """(context managers, extra CLI flags) of a calibrate-cell variant."""
    if variant not in CALIBRATE:
        raise ValueError(f"calibrate cell: unknown variant {variant!r}; one of {CALIBRATE}")
    return {"gs": ([], ["--global_shutter"]), "tf32": ([tf32()], []),
            "frozen": ([frozen_lm()], []), "altered": ([altered_offset()], []),
            "intrinsics": ([offset_intrinsics()], []),
            "ld_fixed": ([line_delay_unfitted()], [])}[variant]


@contextlib.contextmanager
def truth_in_place(state):
    """The detect control: extract_board answered by the render's truth on
    whole pixels (every corner inside the image, rounded)."""
    import numpy as np

    from openimucameracalibrator_torch.core import board_extractor
    from openimucameracalibrator_torch.utils.types import CornerDataset

    n = len(state.pool)

    def factory(real):
        def wrapper(frames, opts, fps=0.0, device=None):
            times = np.asarray([t for t, _ in frames], np.float64)
            idx = np.rint(times * state.fps).astype(np.int64) % n
            return CornerDataset(times, np.rint(state.truth_uv[idx]), state.truth_vis[idx].copy(),
                                 np.zeros((state.truth_uv.shape[1], 3)),
                                 tuple(state.cell.config["image_size"]), fps)
        return wrapper

    with trace.patched(board_extractor, "extract_board", factory):
        yield


@contextlib.contextmanager
def unrefined_corners():
    """Sub-pixel refinement returns the corners it was given."""
    from openimucameracalibrator_torch.detect import image

    def factory(real):
        def wrapper(img_or_fields, corners, *a, **kw):
            return corners
        return wrapper

    with trace.patched(image, "refine_corners_subpix", factory), \
            trace.patched(image, "refine_corners_from_fields", factory):
        yield


@contextlib.contextmanager
def video_output(edit):
    """``edit(k, ids, pts) -> (ids, pts)`` applied to the k-th frame that
    the batched charuco detector yields."""
    from openimucameracalibrator_torch.detect import video

    def factory(real):
        def wrapper(*a, **kw):
            for k, (t, ids, pts) in enumerate(real(*a, **kw)):
                ids, pts = edit(k, ids, pts)
                yield t, ids, pts
        return wrapper

    with trace.patched(video, "detect_charuco_video", factory):
        yield


def _swap_two(k, ids, pts):
    pts = pts.copy()
    if len(ids) >= 2:
        pts[[0, 1]] = pts[[1, 0]]
    return ids, pts


def detect(state) -> list:
    v = state.cell.variant
    if v not in DETECT:
        raise ValueError(f"detect cell: unknown variant {v!r}; one of {DETECT}")
    half = state.opts.batch_frames // 2
    return [{"rounded": lambda: truth_in_place(state),
             "frozen": unrefined_corners,
             "altered": lambda: video_output(_swap_two),
             "half": lambda: video_output(
                 lambda k, ids, pts: (ids[:0], pts[:0]) if k % (2 * half) >= half
                 else (ids, pts))}[v]()]


@contextlib.contextmanager
def batch_result(edit):
    """``edit(real, problems, inits, *a, **kw) -> BatchResult`` in place of
    ``batch_estimator.optimize_batch``."""
    from openimucameracalibrator_torch.core import batch_estimator as be

    def factory(real):
        def wrapper(problems, inits, *a, **kw):
            return edit(real, problems, inits, *a, **kw)
        return wrapper

    with trace.patched(be, "optimize_batch", factory):
        yield


def _altered_batch(real, problems, inits, *a, **kw):
    res = real(problems, inits, *a, **kw)
    res.params[0]["time_offset"] = res.params[0]["time_offset"] + 0.005
    return res


def _half_batch(real, problems, inits, *a, **kw):
    """The first half of the recordings solved; the rest keep their start,
    with the rig blocks taken from the half that was solved."""
    from openimucameracalibrator_torch.core import batch_estimator as be

    h = len(problems) // 2
    res = real(problems[:h], inits[:h], *a, **kw)
    rest = []
    for prm in inits[h:]:
        prm = dict(prm)
        for k in be.DEFAULT_SHARED:
            if k in prm:
                prm[k] = res.params[0][k]
        rest.append(prm)
    return res._replace(params=list(res.params) + rest)


def _batch_line_delay_unfitted(real, problems, inits, *a, flags, **kw):
    return real(problems, inits, *a, flags=_without_line_delay(flags), **kw)


def batch(state) -> list:
    v = state.cell.variant
    if v not in BATCH:
        raise ValueError(f"batch cell: unknown variant {v!r}; one of {BATCH}")
    return {"gs": [], "tf32": [tf32()], "frozen": [frozen_lm()],
            "altered": [batch_result(_altered_batch)], "half": [batch_result(_half_batch)],
            "ld_fixed": [batch_result(_batch_line_delay_unfitted)]}[v]
