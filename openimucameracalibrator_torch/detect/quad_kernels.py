"""Marker quad candidates of a block of dark masks on the card (kernel K3).

:func:`quad_candidates_block` launches the hand-written kernel
``csrc/quad_labels.cu`` (built with ``nvcc`` for ``sm_90a`` at first use by
``utils/native.py``, loaded with ``ctypes``) over an (F, h, w) mask block:
connected components, the largest components' per-row extremes and the quad
fit of ``quads._fit_quads``, with no host synchronisation. It replaces no
TPU kernel: the JAX package labels on the host. Its plain version is the
host route of the batched video path, ``video._host_quads`` (scipy labelling
and ``quads.find_quad_candidates`` frame by frame), which serves CPU blocks
and which the kernel reproduces exactly.

Counters, plain integers on the wrapper: ``launches``, ``frames`` (frames
labelled on the card) and ``truncated_frames`` (frames with more than
``max_quads`` components inside the area limits, where the cut acted).
The last is known only once a block's results reach the host, so the
caller that reads them adds it (:func:`count_truncated`). A call under
CUDA graph capture launches nothing and counts nothing: each replay of the
graph is a launch, which the graph's owner counts (:func:`count_launch`).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from openimucameracalibrator_torch.utils import native

_SYMBOLS = {
    "oicc_quad_workspace_bytes": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "oicc_quad_candidates_block": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                                   + [ctypes.c_double, ctypes.c_int] + [ctypes.c_void_p] * 4,
                                   ctypes.c_int),
}
_INT_MAX = 2 ** 31 - 1


def build() -> native.Library:
    """Compile ``csrc/quad_labels.cu`` (once per source hash) and load it."""
    return native.build("quad_labels.cu", _SYMBOLS)


def _area_limits(h: int, w: int, down: int, marker) -> tuple[int, int]:
    """(lo, hi): the whole-pixel areas that ``find_quad_candidates`` keeps on
    an (h, w) mask at 1/down resolution, ``min_area_px / down^2 <= area <=
    max_area_frac * h * w`` (numpy compares the integer areas with those
    float64 limits)."""
    lo = max(1, math.ceil(marker.min_area_px / (down * down)))
    hi = math.floor(min(marker.max_area_frac, 1.0) * (h * w))
    return lo, hi


def quad_candidates_block(mask: torch.Tensor, down: int, max_quads: int, marker):
    """``(quads (F, Q, 4, 2) f32, qvalid (F, Q) bool, n_kept (F,) int32)``
    on the mask's device, Q = ``max_quads``: for each frame of ``mask``
    (F, h, w) bool, at 1/``down`` of the frame's resolution, what
    ``video._host_quads`` returns (``marker`` gives the area and fill
    limits), and the number of components inside the area limits.

    ``mask`` must be a contiguous 3-D bool CUDA tensor; anything else
    raises. Each launch adds one to ``quad_candidates_block.launches`` and
    F to ``.frames`` (:func:`count_launch`).
    """
    if mask.device.type != "cuda":
        raise ValueError(f"quad_candidates_block: needs a CUDA tensor, got {mask.device} "
                         "(a CPU block takes video._host_quads)")
    if mask.dtype != torch.bool or mask.dim() != 3:
        raise ValueError(f"quad_candidates_block: mask must be a 3-D bool tensor, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("quad_candidates_block: mask must be contiguous")
    Fn, h, w = mask.shape
    Q, down = int(max_quads), int(down)
    if Q < 1 or down < 1 or h * w > _INT_MAX:
        raise ValueError(f"quad_candidates_block: max_quads {Q} and down {down} must be >= 1 "
                         f"and a frame at most {_INT_MAX} pixels, got {h}x{w}")
    dev = mask.device
    quads = torch.empty((Fn, Q, 4, 2), dtype=torch.float32, device=dev)
    qvalid = torch.empty((Fn, Q), dtype=torch.bool, device=dev)
    n_kept = torch.empty((Fn,), dtype=torch.int32, device=dev)
    if Fn == 0:
        return quads, qvalid, n_kept
    lib = build()
    lo, hi = _area_limits(h, w, down, marker)
    cap = max(1, (h * w) // lo)
    ws = torch.empty((lib.lib.oicc_quad_workspace_bytes(Fn, h, w, Q, cap),), dtype=torch.uint8,
                     device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lib.oicc_quad_candidates_block(
        mask.data_ptr(), ws.data_ptr(), Fn, h, w, Q, cap, lo, hi, float(marker.min_fill), down,
        quads.data_ptr(), qvalid.data_ptr(), n_kept.data_ptr(), stream)
    native.check(lib, err, "quad_candidates_block")
    if not torch.cuda.is_current_stream_capturing():
        count_launch(Fn)
    return quads, qvalid, n_kept


quad_candidates_block.launches = 0
quad_candidates_block.frames = 0
quad_candidates_block.truncated_frames = 0


def count_launch(frames: int) -> None:
    """Add one launch over ``frames`` frames to the counters."""
    quad_candidates_block.launches += 1
    quad_candidates_block.frames += int(frames)


def count_truncated(n_kept: np.ndarray, max_quads: int) -> None:
    """Add the frames of a block's fetched ``n_kept`` where the cut at
    ``max_quads`` acted to ``quad_candidates_block.truncated_frames``."""
    quad_candidates_block.truncated_frames += int((np.asarray(n_kept) > max_quads).sum())


def reset_counts():
    quad_candidates_block.launches = 0
    quad_candidates_block.frames = 0
    quad_candidates_block.truncated_frames = 0
