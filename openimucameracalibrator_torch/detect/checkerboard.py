"""Full-grid checkerboard detection (the reference's "radon" board path).

Port of ``detect/checkerboard.py`` of the JAX package. Pipeline:

  1. corner response + NMS + top-K on the frame's device    [image.py,
     the CUDA kernel of detect/kernels.py on the card]
  2. subpixel refinement of all candidates on the device    [image.py]
  3. lattice growing on the host (~hundreds of points): seed at a robust
     interior candidate, two roughly-orthogonal axes, then extend rows and
     columns with the linear prediction 2*p[i] - p[i-1] snapped to the
     nearest unused candidate
  4. full-grid check: exactly (squares_x-1) x (squares_y-1) corners in
     the canonical orientation (axis-1 along +image-x)

The frame stays on the device; only the top-K candidates and the refined
corners come to the host. Like findChessboardCornersSB, it returns all
corners or none. The host seconds of each phase accumulate in
``phase_seconds`` (``reset_phase_seconds`` zeroes them).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.spatial import cKDTree

from openimucameracalibrator_torch.detect import image as im
from openimucameracalibrator_torch.utils import precision

phase_seconds = {"candidates": 0.0, "refine": 0.0, "lattice": 0.0}


def reset_phase_seconds():
    for k in phase_seconds:
        phase_seconds[k] = 0.0


def _grow_lattice(pts: np.ndarray, nx: int, ny: int, snap_tol: float = 0.35):
    """Assign candidates to an (ny, nx) integer lattice. Returns (ny, nx, 2)
    positions or None. ``snap_tol`` is the max prediction error as a
    fraction of the local spacing."""
    n = pts.shape[0]
    if n < nx * ny:
        return None
    tree = cKDTree(pts)

    # Seed: point whose nearest neighbor distance is the global median
    # (robust interior point), axes from its two nearest non-collinear
    # neighbors.
    dists, idxs = tree.query(pts, k=min(5, n))
    order = np.argsort(dists[:, 1])
    for seed in order[len(order) // 4: len(order) // 4 + max(1, n // 2)]:
        p0 = pts[seed]
        a = pts[idxs[seed, 1]] - p0
        ax = None
        for j in range(2, min(5, n)):
            b = pts[idxs[seed, j]] - p0
            cosang = abs(np.dot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
            if cosang < 0.5:
                ax = (a, b)
                break
        if ax is None:
            continue
        grid = _grow_from_seed(pts, tree, seed, ax, snap_tol)
        if grid is None:
            continue
        gh, gw = grid.shape[:2]
        if (gh, gw) == (ny, nx) or (gh, gw) == (nx, ny):
            return _canonicalize(grid, pts, nx, ny)
    return None


def _grow_from_seed(pts, tree, seed, axes, snap_tol):
    """Greedy BFS lattice fill from one seed and two axis vectors."""
    a, b = axes
    spacing = min(np.linalg.norm(a), np.linalg.norm(b))
    tol = snap_tol * spacing
    coord = {seed: (0, 0)}
    pos = {(0, 0): seed}
    frontier = [seed]
    used = {seed}
    while frontier:
        cur = frontier.pop()
        ci, cj = coord[cur]
        for (di, dj) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ni, nj = ci + di, cj + dj
            if (ni, nj) in pos:
                continue
            # prediction: prefer linear extrapolation from two cells back
            prev2 = pos.get((ci - di, cj - dj))
            if prev2 is not None:
                pred = 2 * pts[cur] - pts[prev2]
            else:
                pred = pts[cur] + di * b + dj * a
            d, k = tree.query(pred)
            if d < tol and k not in used:
                pos[(ni, nj)] = k
                coord[k] = (ni, nj)
                used.add(k)
                frontier.append(k)
    if not pos:
        return None
    iis = [ij[0] for ij in pos]
    jjs = [ij[1] for ij in pos]
    i0, i1 = min(iis), max(iis)
    j0, j1 = min(jjs), max(jjs)
    gh, gw = i1 - i0 + 1, j1 - j0 + 1
    if len(pos) != gh * gw:
        return None
    grid = np.zeros((gh, gw, 2))
    for (i, j), k in pos.items():
        grid[i - i0, j - j0] = pts[k]
    return grid


def _canonicalize(grid, pts, nx, ny):
    """Orient the grid so axis-1 (x, nx wide) runs along +image-x and axis-0
    along +image-y; transpose if dims are swapped. 180-degree ambiguity of a
    symmetric board is resolved toward +x."""
    if grid.shape[0] == nx and grid.shape[1] == ny and nx != ny:
        grid = grid.transpose(1, 0, 2)
    dx = grid[:, -1] - grid[:, 0]
    if dx.mean(axis=0)[0] < 0:
        grid = grid[:, ::-1]
    dy = grid[-1] - grid[0]
    if dy.mean(axis=0)[1] < 0:
        grid = grid[::-1]
    return grid


def detect_checkerboard(gray, squares_x: int, squares_y: int,
                        max_corners: int = 512, device=None):
    """Detect a full (squares_x-1) x (squares_y-1) inner-corner grid.

    ``gray`` is a numpy array or a tensor (H, W); it is moved to ``device``
    (default ``"cuda"``) as float32. Returns (ids (K,), corners (K, 2))
    with K = 0 or (sx-1)*(sy-1); ids are row-major over the canonical grid
    (matching boards.radon_board).
    """
    device = precision.resolve_device(device)
    empty = np.zeros((0,), np.int64), np.zeros((0, 2))
    nx, ny = squares_x - 1, squares_y - 1
    t0 = time.perf_counter()
    if isinstance(gray, torch.Tensor):
        g = gray.to(device=device, dtype=torch.float32).contiguous()
    else:
        g = torch.as_tensor(np.asarray(gray, np.float32), device=device)
    xy, score = im.find_corner_candidates(g, max_corners=max_corners)
    xy = xy[score > 0]
    n_cand = xy.shape[0]  # the boolean index synchronises with the device
    t1 = time.perf_counter()
    phase_seconds["candidates"] += t1 - t0
    if n_cand < nx * ny:
        return empty
    refined = im.refine_corners_subpix(g, xy).cpu().numpy()
    t2 = time.perf_counter()
    phase_seconds["refine"] += t2 - t1
    # Drop duplicates that refined to the same point.
    keep = np.ones(len(refined), bool)
    tree = cKDTree(refined)
    for i, j in tree.query_pairs(1.5):
        keep[max(i, j)] = False
    refined = refined[keep]

    grid = _grow_lattice(refined, nx, ny)
    phase_seconds["lattice"] += time.perf_counter() - t2
    if grid is None:
        return empty
    return np.arange(nx * ny, dtype=np.int64), grid.reshape(-1, 2)
