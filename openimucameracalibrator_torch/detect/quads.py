"""Square-marker (ArUco / AprilTag-style) detection.

Port of ``detect/quads.py`` of the JAX package (the replacement for
cv2.aruco.detectMarkers in the reference's BoardExtractor). Pipeline:

  1. adaptive threshold on the frame's device                 [image.py]
  2. connected components of the dark mask (host, scipy)
  3. quad fit per component from its per-row extremes (host, numpy)
  4. subpixel corner refinement on the device, batched        [image.py]
  5. bit sampling under the quad homographies on the device, then the
     dictionary decode on the host (one matmul Hamming argmin) [aruco_dict]

``_fit_quads`` implements the contract its caller relies on: it returns
``(quad (C, 4, 2), ok (C,))`` and ``find_quad_candidates`` keeps
``quad[ok]``. The JAX package's ``_fit_quads`` returns ``quad[ok]`` while
its caller unpacks ``quad, ok`` (and an unclosed docstring stops that
module from parsing at all), so the port follows the caller, which is
what the batched video path and every test of the JAX package expect.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy import ndimage

from openimucameracalibrator_torch.detect import image as im
from openimucameracalibrator_torch.detect.aruco_dict import ArucoDictionary, decode_bits
from openimucameracalibrator_torch.ops import pnp
from openimucameracalibrator_torch.utils import precision


@dataclasses.dataclass
class MarkerDetectorOptions:
    threshold_radius: int = 10
    threshold_c: float = 7.0
    min_area_px: float = 64.0
    max_area_frac: float = 0.25  # of image area
    min_fill: float = 0.5  # component area / quad area
    border_bits: int = 1
    cell_oversample: int = 3
    # Ignored margin per cell when sampling marker bits (OpenCV
    # perspectiveRemoveIgnoredMarginPerCell analog; see
    # image.sample_homography_grid).
    cell_margin: float = 0.13
    subpix_win: int = 4
    max_candidates: int = 256


def _quad_from_hull(hull_pts: np.ndarray) -> np.ndarray | None:
    """4 corner points from convex-hull vertices: the diameter pair plus the
    extreme points on each side of that diagonal. Returns (4, 2) in
    counter-clockwise-in-image order or None."""
    if hull_pts.shape[0] < 4:
        return None
    d = hull_pts[:, None, :] - hull_pts[None, :, :]
    dist2 = (d ** 2).sum(-1)
    i, j = np.unravel_index(np.argmax(dist2), dist2.shape)
    a, b = hull_pts[i], hull_pts[j]
    ab = b - a
    # signed distance of every hull point to line AB
    cross = (hull_pts[:, 0] - a[0]) * ab[1] - (hull_pts[:, 1] - a[1]) * ab[0]
    if cross.max() <= 0 or cross.min() >= 0:
        return None
    c = hull_pts[np.argmax(cross)]
    e = hull_pts[np.argmin(cross)]
    return np.stack([a, c, b, e]).astype(np.float64)


def _order_quad(quad: np.ndarray) -> np.ndarray:
    """Order corners clockwise in image coords (y down) starting top-left."""
    ctr = quad.mean(axis=0)
    ang = np.arctan2(quad[:, 1] - ctr[1], quad[:, 0] - ctr[0])
    quad = quad[np.argsort(ang)]  # CW for y-down
    start = np.argmin(quad.sum(axis=1))
    return np.roll(quad, -start, axis=0)


def _quad_area(q: np.ndarray) -> float:
    x, y = q[:, 0], q[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def find_quad_candidates(mask: np.ndarray, opts: MarkerDetectorOptions):
    """Candidate quads (K, 4, 2) from a binary dark-region mask (host).

    One labeling, then one global group-by (label, row) with an argsort
    and ``reduceat``, giving each component's per-row x extremes (a
    superset of its convex hull); the quad is fitted on those extreme
    points (diameter pair + per-side extremes), all components at once."""
    labels, n = ndimage.label(mask)
    if n == 0:
        return np.zeros((0, 4, 2))
    img_area = mask.shape[0] * mask.shape[1]
    areas = np.bincount(labels.ravel(), minlength=n + 1)[1:]

    ys, xs = np.nonzero(mask)
    lab = labels[ys, xs]
    # nonzero is row-major so within a row xs is ascending; a stable sort
    # by label keeps row-then-x order.
    order_px = np.argsort(lab, kind="stable")
    lab_s, ys_s, xs_s = lab[order_px], ys[order_px], xs[order_px]
    key = lab_s.astype(np.int64) * (mask.shape[0] + 1) + ys_s
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    seg_lab = lab_s[starts]
    seg_row = ys_s[starts]
    x_min = np.minimum.reduceat(xs_s, starts)
    x_max = np.maximum.reduceat(xs_s, starts)
    # per-component segment ranges in the (sorted-by-label) segment list
    comp_starts = np.flatnonzero(np.r_[True, seg_lab[1:] != seg_lab[:-1]])
    comp_ends = np.r_[comp_starts[1:], len(seg_lab)]
    comp_lab = seg_lab[comp_starts]

    sel_area = areas[comp_lab - 1]
    keep = ((sel_area >= opts.min_area_px)
            & (sel_area <= opts.max_area_frac * img_area))
    cand = np.flatnonzero(keep)
    # largest first; equal areas in label order (raster order of their
    # first pixels), so the cut at max_candidates is deterministic
    cand = cand[np.argsort(-sel_area[cand], kind="stable")][:opts.max_candidates]
    if cand.size == 0:
        return np.zeros((0, 4, 2))
    quad, ok = _fit_quads(cand, comp_starts, comp_ends, seg_row, x_min,
                          x_max, sel_area, opts)
    return quad[ok]


def _fit_quads(cand, comp_starts, comp_ends, seg_row, x_min, x_max,
               sel_area, opts):
    """Batched quad fit over the candidate components -> (quad (C, 4, 2),
    ok (C,)).

    Point sets are padded to P slots; components spanning more than P/2
    rows are row-subsampled with a stride (relative corner error <= R/(P/2)
    rows, well inside the bit-sampling margin for marker-sized
    components, which always fit within P/2 rows at practical scales).
    Unused slots repeat the component's first point: duplicates of a real
    boundary point never win the diameter/extreme argmaxes, so no validity
    mask is needed downstream."""
    P = 128
    C = cand.size
    st = comp_starts[cand]
    R = (comp_ends[cand] - st).astype(np.int64)
    stride = np.maximum(1, -(-2 * R // P))  # ceil(2R/P)
    m = -(-R // stride)                     # rows taken per comp
    tot = int(m.sum())
    comp_of = np.repeat(np.arange(C), m)
    cm = np.concatenate([[0], np.cumsum(m)[:-1]])
    j = np.arange(tot) - cm[comp_of]
    seg_idx = st[comp_of] + j * stride[comp_of]
    pts = np.empty((C, P, 2), np.float32)
    first = np.stack([x_min[st], seg_row[st]], -1).astype(np.float32)
    pts[:] = first[:, None, :]
    rows_sel = seg_row[seg_idx].astype(np.float32)
    pts[comp_of, j, 0] = x_min[seg_idx]
    pts[comp_of, j, 1] = rows_sel
    pts[comp_of, j + m[comp_of], 0] = x_max[seg_idx]
    pts[comp_of, j + m[comp_of], 1] = rows_sel

    # diameter pair via the Gram identity (no (C, P, P, 2) diff tensor)
    sq = np.einsum("cpk,cpk->cp", pts, pts)
    G = pts @ np.swapaxes(pts, 1, 2)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * G
    flat = d2.reshape(C, -1).argmax(1)
    i_idx, j_idx = np.divmod(flat, P)
    a = pts[np.arange(C), i_idx]
    b = pts[np.arange(C), j_idx]
    ab = b - a
    cross = ((pts[..., 0] - a[:, None, 0]) * ab[:, None, 1]
             - (pts[..., 1] - a[:, None, 1]) * ab[:, None, 0])
    c = pts[np.arange(C), cross.argmax(1)]
    e = pts[np.arange(C), cross.argmin(1)]
    ok = (cross.max(1) > 0) & (cross.min(1) < 0)
    quad = np.stack([a, c, b, e], axis=1)  # (C, 4, 2)

    # order clockwise-in-image from top-left
    ctr = quad.mean(axis=1, keepdims=True)
    ang = np.arctan2(quad[..., 1] - ctr[..., 1], quad[..., 0] - ctr[..., 0])
    quad = np.take_along_axis(quad, ang.argsort(1)[..., None], axis=1)
    start = quad.sum(-1).argmin(1)
    idx4 = (np.arange(4)[None, :] + start[:, None]) % 4
    quad = np.take_along_axis(quad, idx4[..., None], axis=1)

    x, y = quad[..., 0], quad[..., 1]
    qa = 0.5 * np.abs(np.einsum("ci,ci->c", x, np.roll(y, -1, 1))
                      - np.einsum("ci,ci->c", y, np.roll(x, -1, 1)))
    sides = np.linalg.norm(np.roll(quad, -1, axis=1) - quad, axis=2)
    ok &= (qa > 0) & (sel_area[cand] / np.maximum(qa, 1.0) >= opts.min_fill)
    ok &= (sides.min(1) >= 2.0) & (sides.max(1) / np.maximum(
        sides.min(1), 1e-9) <= 5.0)
    return quad, ok


def _cell_grid_homographies(quads, expand: float = 0.0, device="cpu"):
    """DLT homography (unit square -> image) per quad, float64 on
    ``device``; unit square corners (0,0),(1,0),(1,1),(0,1) map to quad
    corners TL,TR,BR,BL."""
    src = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    if expand:
        src = src * (1 - 2 * expand) + expand
    K = quads.shape[0]
    f64 = dict(dtype=torch.float64, device=device)
    Hs = pnp.homography_dlt(torch.as_tensor(np.broadcast_to(src, (K, 4, 2)).copy(), **f64),
                            torch.as_tensor(np.asarray(quads), **f64),
                            torch.ones((K, 4), **f64))
    return Hs / Hs[:, 2:3, 2:3]


def as_gray(gray, device) -> torch.Tensor:
    """A (H, W) numpy array or tensor as a float32 tensor on ``device``."""
    if isinstance(gray, torch.Tensor):
        return gray.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(gray, np.float32), device=device)


def detect_markers(gray, dictionary: ArucoDictionary,
                   opts: MarkerDetectorOptions | None = None, device=None):
    """Detect dictionary markers in a grayscale image.

    ``gray`` (H, W) goes to ``device`` (default ``"cuda"``) as float32.
    Returns (ids (M,), corners (M, 4, 2)) with corners ordered TL,TR,BR,BL
    of the *canonical* (derotated) marker — matching cv2.aruco conventions.
    """
    device = precision.resolve_device(device)
    opts = opts or MarkerDetectorOptions()
    g = as_gray(gray, device)
    mask = im.adaptive_threshold(g, opts.threshold_radius, opts.threshold_c).cpu().numpy()
    quads = find_quad_candidates(mask, opts)
    if quads.shape[0] == 0:
        return np.zeros((0,), np.int64), np.zeros((0, 4, 2))

    # Subpixel-refine all 4K corners at once.
    flat = quads.reshape(-1, 2)
    refined = im.refine_corners_subpix(g, torch.as_tensor(flat, device=device),
                                       win=opts.subpix_win).cpu().numpy()
    # Reject refinements that ran away.
    bad = np.linalg.norm(refined - flat, axis=1) > opts.subpix_win + 1.0
    refined[bad] = flat[bad]
    quads = refined.reshape(-1, 4, 2)

    n = dictionary.marker_size
    cells = n + 2 * opts.border_bits
    Hs = _cell_grid_homographies(quads, device=device)
    grids = im.sample_homography_grid(g, Hs, cells, cells, opts.cell_oversample,
                                      opts.cell_margin).cpu().numpy()  # (K, cells, cells)

    # Per-marker threshold: midpoint of observed intensity range.
    lo = grids.min(axis=(1, 2), keepdims=True)
    hi = grids.max(axis=(1, 2), keepdims=True)
    bits_all = (grids > (lo + hi) / 2.0).astype(np.uint8)
    bb = opts.border_bits
    border_mask = np.ones((cells, cells), bool)
    border_mask[bb:-bb, bb:-bb] = False
    border_white = bits_all[:, border_mask].mean(axis=1)
    inner = bits_all[:, bb:-bb, bb:-bb]

    ids, rots, _ = decode_bits(inner, dictionary)
    ok = (ids >= 0) & (border_white < 0.2) & ((hi - lo).reshape(-1) > 20.0)
    if not ok.any():
        return np.zeros((0,), np.int64), np.zeros((0, 4, 2))
    # decode: observed == rot90(canonical, r) in array coords, which places
    # canonical corner c at observed image-corner (c - r) mod 4; emit
    # corners in canonical order TL,TR,BR,BL via np.roll(+r).
    sel = np.nonzero(ok)[0]
    out_ids = ids[sel].astype(np.int64)
    out_corners = np.asarray([np.roll(quads[k], int(rots[k]), axis=0) for k in sel])
    # Deduplicate ids (keep first = largest component).
    _, first = np.unique(out_ids, return_index=True)
    return out_ids[first], out_corners[first]
