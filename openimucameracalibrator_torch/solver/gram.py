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
with ``ctypes``); on a CPU tensor it computes the plain version
(:func:`_densify_segments` then ``Dᵀ D``), which is also what the kernel
is held against on the card. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCE = os.path.join(_CSRC, "gram.cu")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused Gram kernel is built with nvcc "
                       "(set CUDA_HOME or put nvcc on PATH)")


class _Library:
    lib = None
    path = ""
    build_seconds = 0.0
    build_log = ""


def build() -> _Library:
    """Compile ``csrc/gram.cu`` (once per source hash) and load it."""
    if _Library.lib is not None:
        return _Library
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libgram_{digest}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {_SOURCE}:\n{proc.stderr}")
        os.replace(tmp, path)
        _Library.build_log = proc.stderr
    lib = ctypes.CDLL(path)
    lib.oicc_fused_gram_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.oicc_fused_gram_f32.restype = ctypes.c_int
    lib.oicc_error_string.argtypes = [ctypes.c_int]
    lib.oicc_error_string.restype = ctypes.c_char_p
    _Library.lib, _Library.path = lib, path
    _Library.build_seconds = time.perf_counter() - t0
    return _Library


@functools.lru_cache(maxsize=None)
def _coltab(segments, L: int, device: str) -> torch.Tensor:
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
    return torch.as_tensor(tab, device=device)


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
    the kernel (float32 J and r, int32 idx, contiguous) or raise. Each
    launch adds one to ``fused_gram.launches`` (and to
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
    lib = build().lib
    tab = _coltab(tuple(segments), int(L), str(dev))
    H = torch.empty((K, L, L), dtype=torch.float32, device=dev)
    g = torch.empty((K, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.oicc_fused_gram_f32(J.data_ptr(), r.data_ptr(), idx.data_ptr(), tab.data_ptr(),
                                  H.data_ptr(), g.data_ptr(), K, R, F, int(L), n_run, stream)
    if err != 0:
        raise RuntimeError("fused_gram kernel launch failed: "
                           + lib.oicc_error_string(err).decode())
    fused_gram.launches += 1
    if tag is not None:
        fused_gram.launches_by_tag[tag] = fused_gram.launches_by_tag.get(tag, 0) + 1
    return H, g


fused_gram.launches = 0
fused_gram.launches_by_tag = {}


def reset_counts():
    fused_gram.launches = 0
    fused_gram.launches_by_tag = {}
