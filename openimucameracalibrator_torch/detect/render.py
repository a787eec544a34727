"""Target rendering without OpenCV: charuco boards, checkerboards, markers.

A copy of ``detect/render.py`` of the JAX package (numpy only).

Replaces the reference's board-PNG generator
(reference applications/create_charuco_board.cc:30-67, which calls
cv::aruco::CharucoBoard::draw) and provides ground-truth imagery for the
detector's closed-loop tests.

Conventions (matching OpenCV's CharucoBoard):
  * square (sx, sy) with (0,0) top-left is black when (sx+sy) is even;
  * markers sit centered in the white squares, ids assigned row-major over
    white squares starting at 0;
  * charuco corner id k lies at pixel (margin + (k % (squares_x-1) + 1)*pps,
    margin + (k // (squares_x-1) + 1)*pps) — i.e. board +y is image-down.
"""

from __future__ import annotations

import numpy as np

from openimucameracalibrator_torch.detect.aruco_dict import ArucoDictionary


def render_marker(dictionary: ArucoDictionary, marker_id: int, px: int,
                  border_bits: int = 1) -> np.ndarray:
    """(px, px) uint8 marker image with a ``border_bits``-cell black border."""
    bits = dictionary.bits[marker_id]
    n = dictionary.marker_size
    cells = np.zeros((n + 2 * border_bits, n + 2 * border_bits), np.uint8)
    cells[border_bits:border_bits + n, border_bits:border_bits + n] = bits
    # Per-pixel cell lookup (exact for non-integer cell sizes).
    idx = (np.arange(px) * cells.shape[0] // px).clip(0, cells.shape[0] - 1)
    img = cells[np.ix_(idx, idx)] * 255
    return img.astype(np.uint8)


def charuco_marker_ids(squares_x: int, squares_y: int) -> np.ndarray:
    """Marker id for each white square, row-major: (n_white,) with the square
    index grid implied by white-square order."""
    n_white = sum(1 for sy in range(squares_y) for sx in range(squares_x)
                  if (sx + sy) % 2 == 1)
    return np.arange(n_white)


def _white_squares(squares_x: int, squares_y: int):
    """Row-major (sx, sy) of white squares (the marker-bearing ones)."""
    out = []
    for sy in range(squares_y):
        for sx in range(squares_x):
            if (sx + sy) % 2 == 1:
                out.append((sx, sy))
    return out


def render_charuco_board(dictionary: ArucoDictionary, squares_x: int,
                         squares_y: int, square_length: float,
                         marker_length: float, px_per_square: int = 100,
                         margin_px: int = 20) -> np.ndarray:
    """(H, W) uint8 charuco board image (255 background)."""
    pps = px_per_square
    H = squares_y * pps + 2 * margin_px
    W = squares_x * pps + 2 * margin_px
    img = np.full((H, W), 255, np.uint8)
    marker_px = max(2, int(round(marker_length / square_length * pps)))
    off = (pps - marker_px) // 2
    mid = 0
    for sy in range(squares_y):
        for sx in range(squares_x):
            y0 = margin_px + sy * pps
            x0 = margin_px + sx * pps
            if (sx + sy) % 2 == 0:
                img[y0:y0 + pps, x0:x0 + pps] = 0
            else:
                m = render_marker(dictionary, mid % dictionary.num_markers,
                                  marker_px)
                img[y0 + off:y0 + off + marker_px,
                    x0 + off:x0 + off + marker_px] = m
                mid += 1
    return img


def render_checkerboard(squares_x: int, squares_y: int, px_per_square: int = 100,
                        margin_px: int = 20) -> np.ndarray:
    """Plain checkerboard (radon-board target), top-left square black."""
    pps = px_per_square
    H = squares_y * pps + 2 * margin_px
    W = squares_x * pps + 2 * margin_px
    img = np.full((H, W), 255, np.uint8)
    for sy in range(squares_y):
        for sx in range(squares_x):
            if (sx + sy) % 2 == 0:
                y0 = margin_px + sy * pps
                x0 = margin_px + sx * pps
                img[y0:y0 + pps, x0:x0 + pps] = 0
    return img


def render_aprilgrid(dictionary: ArucoDictionary, tags_x: int, tags_y: int,
                     tag_px: int = 96, spacing_ratio: float = 0.3,
                     margin_px: int = 30) -> np.ndarray:
    """Kalibr-style aprilgrid image: tags_x * tags_y markers with
    ``spacing_ratio`` * tag_size gaps, ids row-major from 0.

    The grid is rendered bottom-row-first so that tag t at grid (tx, ty)
    with board +y up appears at image row (tags_y-1-ty) — matching the
    board geometry of models/boards.py::apriltag_board.
    """
    gap = int(round(tag_px * spacing_ratio))
    pitch = tag_px + gap
    H = tags_y * pitch - gap + 2 * margin_px
    W = tags_x * pitch - gap + 2 * margin_px
    img = np.full((H, W), 255, np.uint8)
    for ty in range(tags_y):
        for tx in range(tags_x):
            t = ty * tags_x + tx
            y0 = margin_px + (tags_y - 1 - ty) * pitch
            x0 = margin_px + tx * pitch
            img[y0:y0 + tag_px, x0:x0 + tag_px] = render_marker(
                dictionary, t % dictionary.num_markers, tag_px)
    return img


def warp_image(img: np.ndarray, H: np.ndarray, out_shape: tuple,
               border_value: float = 255.0, supersample: int = 2) -> np.ndarray:
    """Warp ``img`` by homography ``H`` (source->dest pixels) into
    ``out_shape`` = (height, width), with bilinear sampling and optional
    supersampled anti-aliasing. Equivalent of cv2.warpPerspective for the
    detector's synthetic tests."""
    h_out, w_out = out_shape
    s = max(1, int(supersample))
    ys, xs = np.meshgrid(
        (np.arange(h_out * s) + 0.5) / s - 0.5,
        (np.arange(w_out * s) + 0.5) / s - 0.5, indexing="ij")
    Hinv = np.linalg.inv(np.asarray(H, np.float64))
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], axis=-1) @ Hinv.T
    u = pts[..., 0] / pts[..., 2]
    v = pts[..., 1] / pts[..., 2]
    out = _bilinear(img.astype(np.float64), u, v, border_value)
    if s > 1:
        out = out.reshape(h_out, s, w_out, s).mean(axis=(1, 3))
    return np.clip(out, 0, 255).astype(np.uint8)


def _bilinear(img, u, v, border_value):
    h, w = img.shape
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    du = u - u0
    dv = v - v0
    out = np.full(u.shape, border_value, np.float64)
    valid = (u0 >= 0) & (u0 < w - 1) & (v0 >= 0) & (v0 < h - 1)
    u0c = np.clip(u0, 0, w - 2)
    v0c = np.clip(v0, 0, h - 2)
    i00 = img[v0c, u0c]
    i01 = img[v0c, u0c + 1]
    i10 = img[v0c + 1, u0c]
    i11 = img[v0c + 1, u0c + 1]
    val = (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
           + i10 * (1 - du) * dv + i11 * du * dv)
    out[valid] = val[valid]
    return out
