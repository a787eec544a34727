"""Solver-state checkpointing (npz pytree snapshots).

The reference only has stage-level file artifacts (extract_board_to_json.cc:
60-64); intra-optimization state is lost on interruption. Here every LM
stage of the continuous-time batch problem can snapshot its solution
(parameter pytree + scalar solver state) so a long calibration — or a
pre-empted job — resumes from the last completed stage instead of
re-running the whole schedule (SURVEY.md §5 checkpoint/resume).

Format: one ``.npz`` per stage holding every array leaf keyed by its dict
name, plus ``__cost``/``__lam``/``__iterations``/``__converged``/
``__status`` and a ``__fingerprint`` string. Loading restores numpy
arrays; callers move them on-device (they are jit inputs anyway).

A checkpoint is only valid for the *same* problem: ``fingerprint(...)``
digests the problem inputs (observation/IMU arrays), the stage schedule,
and the initial-parameter tree structure/shapes/dtypes. ``load_stage``
treats a fingerprint mismatch as absent, so rerunning in a workspace after
inputs change (re-detected corners, different flags, different shapes)
re-solves instead of silently restoring a stale solution.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def fingerprint(*objs) -> str:
    """Order-sensitive sha256 digest over arrays / scalars / strings /
    (nested) dicts, lists, tuples. Array digest covers shape+dtype+bytes."""
    h = hashlib.sha256()

    def feed(o):
        if o is None:
            h.update(b"\x00none")
        elif isinstance(o, (str, bytes)):
            b = o.encode() if isinstance(o, str) else o
            h.update(b"\x01s" + len(b).to_bytes(8, "little") + b)
        elif isinstance(o, dict):
            h.update(b"\x02d")
            for k in sorted(o):
                feed(str(k))
                feed(o[k])
        elif isinstance(o, (list, tuple, frozenset, set)):
            items = sorted(o, key=repr) if isinstance(o, (set, frozenset)) else o
            h.update(b"\x03l" + len(items).to_bytes(8, "little"))
            for it in items:
                feed(it)
        elif isinstance(o, (bool, int, float, complex)):
            feed(repr(o))
        else:
            a = np.asarray(o)
            h.update(b"\x04a" + str(a.shape).encode() + str(a.dtype).encode())
            h.update(np.ascontiguousarray(a).tobytes())

    for o in objs:
        feed(o)
    return h.hexdigest()


def tree_signature(params: dict) -> list:
    """Structure/shape/dtype signature of a parameter pytree (no values)."""
    return [(k, tuple(np.shape(v)), str(np.asarray(v).dtype))
            for k, v in sorted(params.items())]


def stage_path(ckpt_dir: str, stage_idx: int) -> str:
    return os.path.join(ckpt_dir, f"solver_stage_{stage_idx}.npz")


def save_stage(ckpt_dir: str, stage_idx: int, params: dict, *,
               cost=None, lam=None, iterations=None, converged=None,
               status=None, fingerprint: str | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrs = {k: np.asarray(v) for k, v in params.items()}
    for key, val in (("__cost", cost), ("__lam", lam),
                     ("__iterations", iterations), ("__converged", converged),
                     ("__status", status)):
        if val is not None:
            arrs[key] = np.asarray(val)
    if fingerprint is not None:
        arrs["__fingerprint"] = np.asarray(fingerprint)
    path = stage_path(ckpt_dir, stage_idx)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrs)
    os.replace(tmp, path)  # atomic: never leaves a torn checkpoint
    return path


def load_stage(ckpt_dir: str, stage_idx: int, fingerprint: str | None = None):
    """Returns (params dict, meta dict) or None when absent/unreadable.

    When ``fingerprint`` is given, a checkpoint whose stored fingerprint is
    missing or different is treated as absent (stale-input protection)."""
    path = stage_path(ckpt_dir, stage_idx)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            params = {k: z[k] for k in z.files if not k.startswith("__")}
            meta = {k[2:]: z[k] for k in z.files if k.startswith("__")}
    except (OSError, ValueError):
        return None
    if fingerprint is not None and str(meta.get("fingerprint", "")) != fingerprint:
        return None
    return params, meta
