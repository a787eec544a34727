"""Calibration-target geometry: charuco / radon checkerboard / apriltag grid.

Equivalent of the reference's board setup in BoardExtractor
(reference src/core/board_extractor.cc:42-125: InitializeCharucoBoard /
InitializeRadonBoard / InitializeAprilBoard) and its ``BoardToJson`` 3D point
export (:245-266). Here a board is just an id -> 3D point table (z = 0 plane);
detection lives in core/board_extractor.py, synthetic rendering in
utils/synthetic.py.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class BoardType(enum.Enum):
    CHARUCO = "charuco"
    RADON = "radon"
    APRILTAG = "apriltag"


@dataclasses.dataclass(frozen=True)
class Board:
    """A planar target: N corner points with stable integer ids."""

    board_type: BoardType
    points: np.ndarray  # (N, 3), z == 0, meters
    ids: np.ndarray  # (N,) int

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


def charuco_board(squares_x: int = 10, squares_y: int = 8,
                  square_length: float = 0.04, marker_length: float = 0.03,  # noqa: ARG001
                  ) -> Board:
    """Inner chessboard corners of a charuco target.

    Matches OpenCV charuco corner indexing: corner id k sits at
    ((k % (sx-1) + 1) * s, (k // (sx-1) + 1) * s, 0) — row-major over the
    (sx-1) x (sy-1) inner-corner grid. The reference CLI default board is
    10x8 squares (python/run_gopro_calibration.py:40-47).
    """
    nx, ny = squares_x - 1, squares_y - 1
    xs, ys = np.meshgrid(np.arange(1, nx + 1), np.arange(1, ny + 1))
    pts = np.stack([xs.ravel() * square_length, ys.ravel() * square_length,
                    np.zeros(nx * ny)], axis=-1)
    return Board(BoardType.CHARUCO, pts.astype(np.float64), np.arange(nx * ny))


def radon_board(squares_x: int = 10, squares_y: int = 8,
                square_length: float = 0.04) -> Board:
    """Full checkerboard corner grid (findChessboardCornersSB-style)."""
    nx, ny = squares_x - 1, squares_y - 1
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    pts = np.stack([xs.ravel() * square_length, ys.ravel() * square_length,
                    np.zeros(nx * ny)], axis=-1)
    return Board(BoardType.RADON, pts.astype(np.float64), np.arange(nx * ny))


def apriltag_board(tags_x: int = 6, tags_y: int = 6,
                   tag_size: float = 0.088, tag_spacing: float = 0.3) -> Board:
    """Kalibr-style apriltag grid: 4 corners per tag.

    Mirrors the reference's aprilgrid geometry (board_extractor.cc:96-125,
    resource/kalibr_apriltag.yaml): tag t corner c gets id 4*t + c, corners
    ordered (bottom-left, bottom-right, top-right, top-left).
    """
    pitch = tag_size * (1.0 + tag_spacing)
    pts, ids = [], []
    for ty in range(tags_y):
        for tx in range(tags_x):
            t = ty * tags_x + tx
            x0, y0 = tx * pitch, ty * pitch
            corners = [(x0, y0), (x0 + tag_size, y0),
                       (x0 + tag_size, y0 + tag_size), (x0, y0 + tag_size)]
            for c, (x, y) in enumerate(corners):
                pts.append((x, y, 0.0))
                ids.append(4 * t + c)
    return Board(BoardType.APRILTAG, np.asarray(pts, np.float64), np.asarray(ids))


def make_board(board_type: str, squares_x: int, squares_y: int,
               square_length: float, marker_length: float = 0.0) -> Board:
    bt = BoardType(board_type.lower())
    if bt == BoardType.CHARUCO:
        return charuco_board(squares_x, squares_y, square_length, marker_length)
    if bt == BoardType.RADON:
        return radon_board(squares_x, squares_y, square_length)
    return apriltag_board(squares_x, squares_y, square_length, marker_length or 0.3)
