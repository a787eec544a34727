"""Fused densify + Gram for the chunk linearizer: plain version and CUDA kernel.

Counterpart of ``solver/pallas_gram.py`` of the JAX package. For every
chunk k, :func:`fused_gram` returns ``H[k] = D^T D`` and ``g[k] = D^T r``
where ``D (R, L)`` is the dense chunk-local Jacobian assembled from the
compact Jacobian ``J (R, F)`` by a static segment list:

* ``("run", col0, nblk, td, wblk, out_off)`` — ``nblk`` contiguous
  td-wide blocks of J land at block ``idx[row] + kk`` of a ``wblk``-block
  region starting at column ``out_off`` (one per-row index array per run);
* ``("fixed", col0, ncols, out_off)`` — columns shared by all rows.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/gram.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, loaded
with ``ctypes``; it skips the parts of H that no row of a 64-row tile
can reach, from the host table :func:`_tile_reach`); on a CPU
tensor it computes the plain version
(:func:`_densify_segments` then ``Dᵀ D``), which is also what the kernel
is held against on the card. There is no fallback from one to the other.
The build itself is ``utils/native.py``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from openimucameracalibrator_torch.utils import native


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _densify_segments(r, J, segments, L):
    """Scatter-free densification of per-measurement Jacobian blocks.

    ``J (..., C, rd, F)``, ``r (..., C, rd)`` -> ``(Jd (..., C*rd, L),
    r (..., C*rd))``. ``segments`` is the layout-ordered list of
      ("run", col0, nblk, td, blk_idx (..., C), wblk) — block kk of
          measurement m lands at block ``blk_idx[m] + kk`` of a wblk-block
          region, placed by a per-measurement block one-hot, and
      ("fixed", col0, ncols) — contiguous columns shared by all rows.
    Regions are concatenated in order; their total width must equal L.
    """
    *lead, C, rd, F = J.shape
    segs = []
    width = 0
    for seg in segments:
        if seg[0] == "run":
            _, col0, nblk, td, blk_idx, wblk = seg
            Jr = J[..., col0:col0 + nblk * td].reshape(*lead, C, rd, nblk, td)
            tgt = blk_idx[..., None].to(torch.int64) + torch.arange(nblk, device=J.device)
            oh = (tgt[..., None] == torch.arange(wblk, device=J.device)).to(J.dtype)
            Jw = torch.einsum("...mrkc,...mkw->...mrwc", Jr, oh)
            segs.append(Jw.reshape(*lead, C, rd, wblk * td))
            width += wblk * td
        else:
            _, col0, ncols = seg
            segs.append(J[..., col0:col0 + ncols])
            width += ncols
    assert width == L, (width, L)
    return (torch.cat(segs, dim=-1).reshape(*lead, C * rd, L),
            r.reshape(*lead, C * rd))


def _per_row_segments(segments, idx):
    """Kernel-form segments + (n_run, K, R) indices -> _densify_segments form
    over (K, R, 1, F) measurements of one row each."""
    out, run = [], 0
    for seg in segments:
        if seg[0] == "run":
            _, col0, nblk, td, wblk, _ = seg
            out.append(("run", col0, nblk, td, idx[run], wblk))
            run += 1
        else:
            _, col0, ncols, _ = seg
            out.append(("fixed", col0, ncols))
    return out


def fused_gram_plain(J, r, idx, segments, L):
    """Plain PyTorch version: ``_densify_segments`` then ``Dᵀ D``, ``Dᵀ r``.

    Same interface as :func:`fused_gram`; any device and float dtype.
    """
    K, R, F = J.shape
    D, rf = _densify_segments(r[:, :, None], J[:, :, None, :],
                              _per_row_segments(segments, idx), L)
    H = torch.einsum("krl,krm->klm", D, D)
    g = torch.einsum("krl,kr->kl", D, rf)
    return H, g


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_SYMBOLS = {
    "oicc_fused_gram_f32": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                            ctypes.c_int),
    "oicc_gram_scratch_floats": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "oicc_gram_reach_tile": ([], ctypes.c_int),
    "oicc_gram_row_tile": ([], ctypes.c_int),
    "oicc_gram_max_run": ([], ctypes.c_int),
}


def build() -> native.Library:
    """Compile ``csrc/gram.cu`` (once per source hash) and load it."""
    return native.build("gram.cu", _SYMBOLS)


@functools.lru_cache(maxsize=None)
def _coltab_np(segments, L: int) -> np.ndarray:
    """(L, 5) int32 per-column lookup {run, base, b, nblk, td} (see gram.cu)."""
    tab = np.zeros((L, 5), np.int32)
    run = 0
    for seg in segments:
        if seg[0] == "run":
            _, col0, nblk, td, wblk, off = seg
            for c in range(wblk * td):
                b, e = divmod(c, td)
                tab[off + c] = (run, col0 + b * td + e, b, nblk, td)
            run += 1
        else:
            _, col0, ncols, off = seg
            for c in range(ncols):
                tab[off + c] = (-1, col0 + c, 0, 0, 0)
    return tab


@functools.lru_cache(maxsize=None)
def _tile_reach(segments, L: int, tile: int, max_run: int) -> np.ndarray:
    """(ceil(L / tile), 2 * max_run + 1) int32: for each group of ``tile``
    columns of H (the kernel's 16-column half tiles) and each run q <
    ``max_run`` (gram.cu's MAX_RUN, which fixes the row stride the kernel
    reads), the interval [lo, hi] of block indices ``idx[q][row]`` that put
    a nonzero of D in one of the group's columns (lo > hi when none can),
    then 1 if the group holds a fixed column.

    A run column at block b of a run with nblk blocks is reached by
    b - nblk < idx <= b; a group's run-q columns hold consecutive blocks."""
    tab = _coltab_np(segments, L)
    n_tiles = -(-L // tile)
    out = np.zeros((n_tiles, 2 * max_run + 1), np.int32)
    out[:, 0:2 * max_run:2], out[:, 1:2 * max_run:2] = 1, 0
    for t in range(n_tiles):
        cols = tab[t * tile:(t + 1) * tile]
        out[t, -1] = int(np.any(cols[:, 0] == -1))
        for q in range(max_run):
            b, nblk = cols[cols[:, 0] == q, 2], cols[cols[:, 0] == q, 3]
            if b.size:
                out[t, 2 * q], out[t, 2 * q + 1] = (b - nblk + 1).min(), b.max()
    return out


@functools.lru_cache(maxsize=None)
def _device_tables(segments, L: int, tile: int, max_run: int, device: str):
    return (torch.as_tensor(_coltab_np(segments, L), device=device),
            torch.as_tensor(_tile_reach(segments, L, tile, max_run), device=device))


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_gram: {name} must be {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"fused_gram: {name} must be contiguous")


def fused_gram(J, r, idx, segments, L: int, tag: str | None = None):
    """``(H (K, L, L), g (K, L))`` for ``J (K, R, F)``, ``r (K, R)`` and the
    per-row block indices ``idx (n_run, K, R)`` of the run segments.

    ``segments`` is a hashable tuple of kernel-form segments (module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    the kernel (float32 J and r, int32 idx, contiguous) or raise. Any idx
    gives the exact result; time-sorted rows let the kernel skip more of
    D's zero blocks. Each launch (one C call: the per-row-tile index
    ranges, the Gram, and the sum of the 1024-row slabs when a chunk has
    more than one) adds one to ``fused_gram.launches`` (and to
    ``fused_gram.launches_by_tag[tag]`` when a tag is given).
    """
    if J.device.type == "cpu":
        return fused_gram_plain(J, r, idx, segments, L)
    if J.device.type != "cuda":
        raise ValueError(f"fused_gram: unsupported device {J.device}")
    K, R, F = J.shape
    n_run = sum(1 for s in segments if s[0] == "run")
    dev = J.device
    _check("J", J, torch.float32, (K, R, F), dev)
    _check("r", r, torch.float32, (K, R), dev)
    _check("idx", idx, torch.int32, (n_run, K, R), dev)
    lib = build()
    L = int(L)
    tab, reach = _device_tables(tuple(segments), L, lib.lib.oicc_gram_reach_tile(),
                                lib.lib.oicc_gram_max_run(), str(dev))
    rows = lib.lib.oicc_gram_row_tile()
    H = torch.empty((K, L, L), dtype=torch.float32, device=dev)
    g = torch.empty((K, L), dtype=torch.float32, device=dev)
    ranges = torch.empty((max(n_run * K * (-(-R // rows)), 1), 2), dtype=torch.int32,
                         device=dev)
    part = torch.empty((max(lib.lib.oicc_gram_scratch_floats(K, R, L), 1),),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lib.oicc_fused_gram_f32(J.data_ptr(), r.data_ptr(), idx.data_ptr(),
                                      tab.data_ptr(), reach.data_ptr(), ranges.data_ptr(),
                                      part.data_ptr(), H.data_ptr(), g.data_ptr(), K, R, F, L,
                                      n_run, stream)
    native.check(lib, err, "fused_gram")
    fused_gram.launches += 1
    if tag is not None:
        fused_gram.launches_by_tag[tag] = fused_gram.launches_by_tag.get(tag, 0) + 1
    return H, g


fused_gram.launches = 0
fused_gram.launches_by_tag = {}


def reset_counts():
    fused_gram.launches = 0
    fused_gram.launches_by_tag = {}
