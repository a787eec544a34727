"""Fused checkerboard corner response + NMS: plain version and CUDA kernel.

Counterpart of ``detect/pallas_kernels.py`` of the JAX package (kernel K2
of the port). :func:`corner_response_nms` returns, for a frame, the
corner-likelihood map of ``image.corner_response`` and the mask of its
local maxima over a (2n+1)^2 window, in one pass:

* on a CUDA tensor it launches the hand-written kernel
  ``csrc/corner_nms.cu`` (built with ``nvcc`` for ``sm_90a`` at first use
  by ``utils/native.py``, loaded with ``ctypes``), or raises;
* :func:`corner_response_nms_plain` is the plain version (``F.conv2d``
  with the 8 quadrant kernels, the response reduction, ``F.max_pool2d``),
  which serves CPU tensors and is what the kernel is held against.

The block mode, :func:`corner_response_block`, is the same kernel over an
(F, H, W) block of frames with the response alone (no mask, no NMS halo),
in one launch: what the video path (``detect/video.py``) and the charuco
response check need. Its plain version :func:`corner_response_block_plain`
is the first half of the plain version above over the F frames (one
``F.conv2d`` with the frames as the batch). Block launches count in
``corner_response_block.launches``, apart from
``corner_response_nms.launches``.

:func:`find_corner_candidates_kernel` (the counterpart of
``find_corner_candidates_pallas``) thresholds and takes the top K outside
the kernel, with a stable sort so that equal scores keep the lower flat
index first, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from openimucameracalibrator_torch.detect import image as image_mod
from openimucameracalibrator_torch.utils import native


def _tap_tables(radius: int):
    """(dys, dxs, ws) each (8, Kmax): nonzero taps of the 8 quadrant
    kernels (2 prototypes x 4 quadrants), zero-weight padded to a common
    length: the JAX package's tap table (the CUDA kernel reads
    :func:`_packed_taps`)."""
    bank = image_mod._prototype_bank(radius)  # (2, 4, s, s)
    quads = []
    for p in range(2):
        for q in range(4):
            k = bank[p, q]
            ys, xs = np.nonzero(k)
            quads.append([(int(y), int(x), float(k[y, x]))
                          for y, x in zip(ys, xs)])
    kmax = max(len(q) for q in quads)
    dys = np.zeros((8, kmax), np.int32)
    dxs = np.zeros((8, kmax), np.int32)
    ws = np.zeros((8, kmax), np.float32)
    for i, q in enumerate(quads):
        for j, (dy, dx, w) in enumerate(q):
            dys[i, j], dxs[i, j], ws[i, j] = dy, dx, w
    return dys, dxs, ws


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _response_from_quadrants(out: torch.Tensor) -> torch.Tensor:
    """(..., 8, H, W) quadrant correlations -> (..., H, W) response,
    clamped >= 0."""
    resp = None
    for p in range(2):
        a, b, c, d = (out[..., 4 * p + q, :, :] for q in range(4))
        mu = 0.25 * (a + b + c + d)
        r1 = torch.minimum(torch.minimum(a, b) - mu, mu - torch.maximum(c, d))
        r2 = torch.minimum(mu - torch.maximum(a, b), torch.minimum(c, d) - mu)
        r = torch.maximum(r1, r2)
        resp = r if resp is None else torch.maximum(resp, r)
    return torch.clamp(resp, min=0.0)


def corner_response_block_plain(imgs: torch.Tensor, radius: int = 6) -> torch.Tensor:
    """Plain PyTorch version of :func:`corner_response_block`, any device:
    the response (F, H, W) f32 of each frame of ``imgs`` (F, H, W)."""
    bank = torch.as_tensor(image_mod._prototype_bank(radius), device=imgs.device)
    k = bank.reshape(8, 1, bank.shape[-2], bank.shape[-1])
    out = F.conv2d(imgs.to(torch.float32)[:, None], k, padding=radius)
    return _response_from_quadrants(out)


def corner_response_nms_plain(img: torch.Tensor, radius: int = 6, nms_radius: int = 4):
    """Plain PyTorch version of :func:`corner_response_nms`, any device:
    ``(resp (H, W) f32, keep (H, W) f32)``."""
    resp = corner_response_block_plain(img[None], radius)[0]
    n = nms_radius
    local_max = F.max_pool2d(resp[None, None], 2 * n + 1, stride=1, padding=n)[0, 0]
    return resp, (resp >= local_max).to(torch.float32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_SYMBOLS = {
    "oicc_corner_nms_f32": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                            ctypes.c_int),
    "oicc_corner_nms_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_longlong),
    "oicc_corner_response_block_f32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p], ctypes.c_int),
    "oicc_corner_response_smem_bytes": ([ctypes.c_int], ctypes.c_longlong),
}
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper


def build() -> native.Library:
    """Compile ``csrc/corner_nms.cu`` (once per source hash) and load it."""
    return native.build("corner_nms.cu", _SYMBOLS)


def _in_quad(q: int, dy: int, dx: int) -> bool:
    """Whether tap (dy, dx) belongs to quadrant kernel q (4 * prototype +
    {a, b, c, d}); the rule ``in_quad`` of ``csrc/corner_nms.cu``."""
    d1, d2 = (dy, -dx) if q < 4 else (dy - dx, -(dx + dy))
    return [d1 < 0 and d2 < 0, d1 > 0 and d2 > 0, d1 < 0 and d2 > 0, d1 > 0 and d2 < 0][q % 4]


@functools.lru_cache(maxsize=None)
def _packed_taps(radius: int) -> np.ndarray:
    """(8 r^2,) float32: the nonzero weights of the 8 quadrant kernels in the
    kernel's loop order (dx, then quadrant, then dy), as ``corner_nms.cu``
    reads them. Raises if ``_in_quad`` does not give exactly the prototype
    bank's nonzero taps."""
    r = radius
    bank = image_mod._prototype_bank(r).reshape(8, 2 * r + 1, 2 * r + 1)
    span = range(-r, r + 1)
    mask = np.array([[[_in_quad(q, dy, dx) for dx in span] for dy in span] for q in range(8)])
    if not np.array_equal(mask, bank != 0):
        raise ValueError(f"corner_response_nms: the kernel's tap rule does not match "
                         f"the prototype bank at radius {radius}")
    return np.ascontiguousarray(bank.transpose(2, 0, 1)[mask.transpose(2, 0, 1)],
                                dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _device_taps(radius: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_packed_taps(radius), device=device)


def corner_response_nms(img: torch.Tensor, radius: int = 6, nms_radius: int = 4):
    """``(resp (H, W) f32, keep (H, W) f32)``: the corner response and its
    (2n+1)^2 local-max mask, from the CUDA kernel.

    ``img`` must be a contiguous 2-D float32 CUDA tensor; anything else
    raises. (radius, nms_radius) = (6, 4) runs the kernel compiled for
    those sizes, any other pair its generic instantiation. Each launch adds
    one to ``corner_response_nms.launches``.
    """
    if img.device.type != "cuda":
        raise ValueError(f"corner_response_nms: needs a CUDA tensor, got {img.device} "
                         "(use corner_response_nms_plain on the CPU)")
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError(f"corner_response_nms: img must be a 2-D float32 tensor, "
                         f"got {img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("corner_response_nms: img must be contiguous")
    radius, nms_radius = int(radius), int(nms_radius)
    if radius < 1 or nms_radius < 0:
        raise ValueError(f"corner_response_nms: radius {radius} must be >= 1 and "
                         f"nms_radius {nms_radius} >= 0")
    lib = build()
    if lib.lib.oicc_corner_nms_smem_bytes(radius, nms_radius) > _MAX_SMEM:
        raise ValueError(f"corner_response_nms: radius {radius} / nms_radius {nms_radius} "
                         "need more shared memory than a block has")
    w_host = _packed_taps(radius)
    w_dev = _device_taps(radius, str(img.device))
    H, W = img.shape
    resp = torch.empty_like(img)
    keep = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
    err = lib.lib.oicc_corner_nms_f32(img.data_ptr(), w_host.ctypes.data, w_dev.data_ptr(),
                                      resp.data_ptr(), keep.data_ptr(), H, W, radius,
                                      nms_radius, stream)
    native.check(lib, err, "corner_response_nms")
    corner_response_nms.launches += 1
    return resp, keep


corner_response_nms.launches = 0


def corner_response_block(imgs: torch.Tensor, radius: int = 6) -> torch.Tensor:
    """The corner response (F, H, W) f32 of each frame of ``imgs``
    (F, H, W), from the CUDA kernel in its block mode: one launch for the
    block, response only.

    ``imgs`` must be a contiguous 3-D float32 CUDA tensor; anything else
    raises. Radius 6 runs the kernel compiled for it, any other radius its
    generic instantiation. Each launch adds one to
    ``corner_response_block.launches``.
    """
    if imgs.device.type != "cuda":
        raise ValueError(f"corner_response_block: needs a CUDA tensor, got {imgs.device} "
                         "(use corner_response_block_plain on the CPU)")
    if imgs.dtype != torch.float32 or imgs.dim() != 3:
        raise ValueError(f"corner_response_block: imgs must be a 3-D float32 tensor, "
                         f"got {imgs.dtype} {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("corner_response_block: imgs must be contiguous")
    radius = int(radius)
    if radius < 1:
        raise ValueError(f"corner_response_block: radius {radius} must be >= 1")
    lib = build()
    if lib.lib.oicc_corner_response_smem_bytes(radius) > _MAX_SMEM:
        raise ValueError(f"corner_response_block: radius {radius} needs more shared memory "
                         "than a block has")
    w_host = _packed_taps(radius)
    w_dev = _device_taps(radius, str(imgs.device))
    Fn, H, W = imgs.shape
    resp = torch.empty_like(imgs)
    if Fn == 0:
        return resp
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
    err = lib.lib.oicc_corner_response_block_f32(imgs.data_ptr(), w_host.ctypes.data,
                                                 w_dev.data_ptr(), resp.data_ptr(), Fn, H, W,
                                                 radius, stream)
    native.check(lib, err, "corner_response_block")
    corner_response_block.launches += 1
    return resp


corner_response_block.launches = 0


def reset_counts():
    corner_response_nms.launches = 0
    corner_response_block.launches = 0


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------

def top_candidates(resp: torch.Tensor, keep: torch.Tensor, max_corners: int,
                   rel_threshold: float):
    """(xy (K, 2) f32, score (K,)): local maxima above ``rel_threshold``
    times the largest response, best first; equal scores lower flat index
    first; score 0 for empty slots."""
    thr = rel_threshold * torch.max(resp)
    flat = torch.where((keep > 0) & (resp > thr), resp, torch.zeros_like(resp)).reshape(-1)
    scores, idx = torch.sort(flat, descending=True, stable=True)
    scores, idx = scores[:max_corners], idx[:max_corners]
    w = resp.shape[1]
    xs = (idx % w).to(torch.float32)
    ys = (idx // w).to(torch.float32)
    return torch.stack([xs, ys], dim=-1), scores


def find_corner_candidates_kernel(img: torch.Tensor, max_corners: int = 512,
                                  nms_radius: int = 4, rel_threshold: float = 0.05,
                                  response_radius: int = 6):
    """``image.find_corner_candidates`` through the CUDA kernel."""
    resp, keep = corner_response_nms(img, response_radius, nms_radius)
    return top_candidates(resp, keep, max_corners, rel_threshold)
