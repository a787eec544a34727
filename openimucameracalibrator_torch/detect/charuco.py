"""Charuco corner detection: markers -> interpolated chessboard corners.

Port of ``detect/charuco.py`` of the JAX package (the native replacement
for cv2.aruco.interpolateCornersCharuco of the reference's BoardExtractor
charuco path): detected marker corners anchor local board->image
homographies; chessboard corner positions are predicted from those and
refined to subpixel on the image; a corner-response check rejects
predictions that do not land on an x-corner. The frame stays on its
device: the marker stage (``detect/quads.py``), the local homographies
(one batched DLT), the refinement and the response (``image.corner_response``,
the CUDA kernel K2 on a CUDA frame) run there; the per-corner bookkeeping
is host numpy.

Board conventions match models/boards.py + detect/render.py: squares (sx,
sy) from the top-left, (sx+sy) even = black, markers row-major in white
squares, charuco corner id k at board point ((k % (nx) + 1) * s,
(k // nx + 1) * s) with nx = squares_x - 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openimucameracalibrator_torch.detect import aruco_dict as adict_sub
from openimucameracalibrator_torch.detect import image as im
from openimucameracalibrator_torch.detect import quads
from openimucameracalibrator_torch.detect.aruco_dict import (ArucoDictionary,
                                                             aruco_original_dictionary)
from openimucameracalibrator_torch.detect.render import _white_squares
from openimucameracalibrator_torch.ops import pnp
from openimucameracalibrator_torch.utils import precision


@dataclasses.dataclass
class CharucoBoardSpec:
    squares_x: int = 10
    squares_y: int = 8
    square_length: float = 0.04
    marker_length: float = 0.03
    dictionary: ArucoDictionary | None = None

    def __post_init__(self):
        if self.dictionary is None:
            self.dictionary = aruco_original_dictionary()

    def marker_board_corners(self) -> tuple[np.ndarray, np.ndarray]:
        """(marker_ids (Nw,), corners (Nw, 4, 2)): board-frame (x, y) of each
        marker's TL,TR,BR,BL corners (board +y = image-down on the board)."""
        s, ml = self.square_length, self.marker_length
        off = (s - ml) / 2.0
        ids, corners = [], []
        for mid, (sx, sy) in enumerate(_white_squares(self.squares_x, self.squares_y)):
            x0, y0 = sx * s + off, sy * s + off
            corners.append([(x0, y0), (x0 + ml, y0), (x0 + ml, y0 + ml), (x0, y0 + ml)])
            ids.append(mid)
        return np.asarray(ids), np.asarray(corners, np.float64)

    def chessboard_corners(self) -> np.ndarray:
        """(N, 2) board-frame positions of charuco corners, id order."""
        nx, ny = self.squares_x - 1, self.squares_y - 1
        xs, ys = np.meshgrid(np.arange(1, nx + 1), np.arange(1, ny + 1))
        return np.stack([xs.ravel(), ys.ravel()], -1) * self.square_length


@dataclasses.dataclass
class CharucoDetectorOptions:
    marker: quads.MarkerDetectorOptions = dataclasses.field(
        default_factory=quads.MarkerDetectorOptions)
    min_markers: int = 2
    local_markers: int = 4  # nearest markers used per corner homography
    subpix_win: int = 5
    max_residual_px: float = 5.0  # refined-vs-predicted distance gate
    response_check: bool = True


def detect_charuco(gray, spec: CharucoBoardSpec,
                   opts: CharucoDetectorOptions | None = None, device=None):
    """Detect charuco corners in one grayscale frame.

    ``gray`` (H, W) goes to ``device`` (default ``"cuda"``) as float32.
    Returns (corner_ids (K,), corners_px (K, 2)).
    """
    device = precision.resolve_device(device)
    opts = opts or CharucoDetectorOptions()
    empty = np.zeros((0,), np.int64), np.zeros((0, 2))
    board_mids, board_mcorners = spec.marker_board_corners()
    # Decode against the BOARD's id subset, not the full dictionary: a
    # misdecode onto another valid board id corrupts the local corner
    # homographies (whole neighborhoods shift by one square); the subset
    # raises the effective code distance and re-derives the correction
    # budget from it (see aruco_dict.subset_dictionary).
    sub, id_map = adict_sub.subset_dictionary(spec.dictionary, board_mids)
    g = quads.as_gray(gray, device)
    mids_sub, mcorners = quads.detect_markers(g, sub, opts.marker, device=device)
    mids = id_map[mids_sub]
    if len(mids) < opts.min_markers:
        return empty

    # Board-frame positions of the observed marker corners.
    obs_board = board_mcorners[mids]  # (M, 4, 2)
    obs_img = mcorners  # (M, 4, 2)
    marker_ctr_board = obs_board.mean(axis=1)  # (M, 2)

    chess = spec.chessboard_corners()  # (N, 2)
    N = chess.shape[0]

    # Per-corner local homography from the nearest `local_markers` markers:
    # one DLT per distinct marker set, all sets in one batched call.
    n_loc = min(opts.local_markers, len(mids))
    src_sets = {}
    for k in range(N):
        d = np.linalg.norm(marker_ctr_board - chess[k], axis=1)
        sel = tuple(np.sort(np.argsort(d)[:n_loc]))
        src_sets.setdefault(sel, []).append(k)
    sels = [list(s) for s in src_sets]
    f64 = dict(dtype=torch.float64, device=device)
    bp = torch.as_tensor(np.stack([obs_board[s].reshape(-1, 2) for s in sels]), **f64)
    ip = torch.as_tensor(np.stack([obs_img[s].reshape(-1, 2) for s in sels]), **f64)
    Hs = pnp.homography_dlt(bp, ip, torch.ones(bp.shape[:2], **f64)).cpu().numpy()

    preds = np.zeros((N, 2))
    ok = np.zeros((N,), bool)
    for H, corner_ids in zip(Hs, src_sets.values()):
        if not np.isfinite(H).all() or abs(H[2, 2]) < 1e-12:
            continue
        pts = np.concatenate([chess[corner_ids], np.ones((len(corner_ids), 1))], axis=1) @ H.T
        w = pts[:, 2:3]
        good = np.abs(w[:, 0]) > 1e-9
        preds[corner_ids] = np.where(good[:, None], pts[:, :2] / np.where(good[:, None], w, 1.0),
                                     0.0)
        ok[np.asarray(corner_ids)[good]] = True

    h, w_img = g.shape
    inb = (preds[:, 0] > 3) & (preds[:, 0] < w_img - 4) & \
          (preds[:, 1] > 3) & (preds[:, 1] < h - 4)
    ok &= inb
    if not ok.any():
        return empty

    cand = preds[ok]
    refined_t = im.refine_corners_subpix(g, torch.as_tensor(cand, device=device),
                                         win=opts.subpix_win)
    refined = refined_t.cpu().numpy()
    drift = np.linalg.norm(refined - cand, axis=1)
    good = drift < opts.max_residual_px

    if opts.response_check:
        resp = im.corner_response(g)
        rx = torch.clamp(torch.round(refined_t[:, 0]).to(torch.int64), 0, w_img - 1)
        ry = torch.clamp(torch.round(refined_t[:, 1]).to(torch.int64), 0, h - 1)
        rmax = float(resp.max())
        thr = 0.02 * rmax if rmax > 0 else 0.0
        good &= (resp[ry, rx] > thr).cpu().numpy()

    ids_out = np.nonzero(ok)[0][good]
    return ids_out.astype(np.int64), refined[good].astype(np.float64)
