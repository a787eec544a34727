"""Carry parameters and problems across from the JAX package as numpy.

The JAX package's spline parameter dict, ``SplineProblem`` fields, the
camera calibrator's parameter dict, lists of problems and parameter dicts
(one per sequence of a multi-sequence batch) and a stacked
``SequenceBatch``, given as numpy arrays (``{k: np.asarray(v)}``), become
the port's tensors and back, so that both packages compute from the same
state. This module imports nothing of the JAX package: the caller
converts to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from openimucameracalibrator_torch.core import spline_estimator as se
from openimucameracalibrator_torch.utils import precision

PARAM_KEYS = ("q_so3", "t_r3", "bias_a", "bias_g", "gravity", "q_i_c", "t_i_c",
              "line_delay", "time_offset", "accl_intr", "gyro_intr", "points")


def params_from_numpy(d: dict, device=None, dtype=None) -> dict:
    """Spline parameter dict of numpy arrays -> dict of tensors."""
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    unknown = set(d) - set(PARAM_KEYS)
    if unknown:
        raise KeyError(f"unknown spline parameter(s): {sorted(unknown)}")
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in d.items()}


def params_to_numpy(params: dict) -> dict:
    """Dict of tensors -> dict of float64 numpy arrays."""
    return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in params.items()}


def problem_from_numpy(fields: dict, device=None, dtype=None) -> se.SplineProblem:
    """``SplineProblem`` fields (numpy arrays, Python scalars, None) ->
    the port's ``SplineProblem``. Float arrays take ``dtype``, boolean
    masks stay boolean, integer index arrays become int64."""
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    out = {}
    for k, v in fields.items():
        if v is None or isinstance(v, (bool, int, float, str)):
            out[k] = v
            continue
        a = np.array(v)  # a writable copy
        if a.ndim == 0:
            out[k] = a.item()
        elif a.dtype == bool:
            out[k] = torch.as_tensor(a, device=device)
        elif np.issubdtype(a.dtype, np.integer):
            out[k] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            out[k] = torch.as_tensor(a, dtype=dtype, device=device)
    return se.SplineProblem(**out)


BA_PARAM_KEYS = ("cam", "q_cw", "t_cw", "pts")


def ba_params_from_numpy(d: dict, device=None, dtype=None) -> dict:
    """Camera-calibrator parameter dict (``cam``, ``q_cw``, ``t_cw``,
    ``pts``) of numpy arrays -> dict of tensors; a leading lane axis (the
    lane-stacked dict of ``calibrate_camera_batch``) is kept."""
    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    if set(d) != set(BA_PARAM_KEYS):
        raise KeyError(f"calibrator parameters must be {BA_PARAM_KEYS}, got {sorted(d)}")
    return {k: torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)
            for k in BA_PARAM_KEYS}


def ba_params_to_numpy(params: dict) -> dict:
    """Camera-calibrator parameter dict of tensors -> float64 numpy arrays."""
    return params_to_numpy({k: params[k] for k in BA_PARAM_KEYS})


def problems_from_numpy(fields_list, device=None, dtype=None) -> list:
    """A list of ``SplineProblem`` field dicts -> a list of the port's
    problems (one per sequence of a multi-sequence batch)."""
    return [problem_from_numpy(f, device=device, dtype=dtype) for f in fields_list]


def params_list_from_numpy(dicts, device=None, dtype=None) -> list:
    """A list of spline parameter dicts of numpy arrays -> dicts of tensors."""
    return [params_from_numpy(d, device=device, dtype=dtype) for d in dicts]


def sequence_batch_from_numpy(fields: dict, device=None, dtype=None):
    """A stacked multi-sequence batch (the JAX package's ``SequenceBatch``
    fields as numpy: ``p_ref`` a problem-field dict, ``plans`` three
    ``(n_chunks, chunk, w_s, w_r, s_base, r_base)`` tuples, ``arrs`` and
    ``bases`` dicts of arrays, ``pad_masks``, ``knot_counts``, ``n_seq``)
    -> the port's ``batch_estimator.SequenceBatch``."""
    from openimucameracalibrator_torch.core import batch_estimator as be

    device = precision.resolve_device(device)
    dtype = precision.resolve(dtype, device)
    p_ref = problem_from_numpy(fields["p_ref"], device=device, dtype=dtype)
    plans = tuple(se.ChunkPlan(int(k), int(c), int(ws), int(wr),
                               None if sb is None else np.asarray(sb, np.int64),
                               None if rb is None else np.asarray(rb, np.int64))
                  for k, c, ws, wr, sb, rb in fields["plans"])

    def tensor(a):
        a = np.array(a)
        if a.dtype == bool:
            return torch.as_tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    arrs = {k: tensor(v) for k, v in fields["arrs"].items()}
    bases = {k: (np.asarray(v, np.int64) if k not in se.PROBLEM_OVERRIDE_KEYS else tensor(v))
             for k, v in fields["bases"].items()}
    return be.SequenceBatch(p_ref=p_ref, plans=plans, arrs=arrs, bases=bases,
                            pad_masks=np.asarray(fields["pad_masks"], np.float64),
                            knot_counts=tuple(tuple(int(x) for x in kc)
                                              for kc in fields["knot_counts"]),
                            n_seq=int(fields["n_seq"]))
