"""Board corner extraction from frames, videos and image folders.

Port of ``core/board_extractor.py`` of the JAX package, for the radon
(plain checkerboard) board: ``extract_board`` runs the native detector
(``detect/checkerboard.py``) on each (time, gray) frame and assembles the
statically-shaped ``CornerDataset`` the calibration stages consume. The
frames go to ``device`` (default ``"cuda"``) one at a time.

Not ported yet (each raises ``NotImplementedError``): the charuco and
apriltag boards and the detector-parameter file (they need
``detect/quads.py``, ``charuco.py``, ``video.py`` and ``params.py``; the
batched video path of the JAX package serves only charuco), and the
OpenCV backend. The options of those paths (dictionary override, video
batching) come with them. Video decoding needs cv2 and
image folders PIL; both are imported only where they are used.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator

import numpy as np

from openimucameracalibrator_torch.detect import checkerboard as checker_mod
from openimucameracalibrator_torch.models import boards as boards_mod
from openimucameracalibrator_torch.utils import precision
from openimucameracalibrator_torch.utils.types import CornerDataset

_NOT_PORTED = ("is not ported yet: it needs detect/quads.py, charuco.py, video.py and "
               "params.py (ROADMAP.md queue 1, item 10)")


@dataclasses.dataclass
class BoardExtractorOptions:
    board_type: str = "charuco"
    squares_x: int = 10
    squares_y: int = 8
    square_length: float = 0.04
    marker_length: float = 0.03
    aruco_dict: str = "DICT_ARUCO_ORIGINAL"  # board_extractor.cc:46 default
    downsample_factor: float = 1.0  # resize 1/f (board_extractor.cc:414-430)
    backend: str = "native"  # "native" ("opencv" is not ported)
    detector_params_path: str = ""  # not ported (detect/params.py)


def make_native_detector(opts: BoardExtractorOptions, device=None):
    """detect(gray) -> (ids, corners_px) using the in-house stack."""
    bt = boards_mod.BoardType(opts.board_type.lower())
    if bt != boards_mod.BoardType.RADON:
        raise NotImplementedError(f"the {bt.value} board {_NOT_PORTED}")
    if opts.detector_params_path:
        raise NotImplementedError(f"the detector-parameter file {_NOT_PORTED}")
    device = precision.resolve_device(device)
    return lambda g: checker_mod.detect_checkerboard(g, opts.squares_x, opts.squares_y,
                                                     device=device)


# ---------------------------------------------------------------------------
# Frame sources
# ---------------------------------------------------------------------------

def iter_video_frames(video_path: str, downsample: float = 1.0) -> Iterator[tuple]:
    """(timestamp_s, gray frame) per video frame (board_extractor.cc:385-430).

    Tolerates up to 500 consecutive bad reads like the reference
    (:415-418). Requires cv2 for decode.
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    bad = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            bad += 1
            if bad > 500:
                break
            if cap.get(cv2.CAP_PROP_POS_FRAMES) >= cap.get(cv2.CAP_PROP_FRAME_COUNT):
                break
            continue
        bad = 0
        t = cap.get(cv2.CAP_PROP_POS_MSEC) * 1e-3
        if downsample and downsample != 1.0:
            frame = cv2.resize(frame, None, fx=1.0 / downsample, fy=1.0 / downsample)
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        yield t, gray
    cap.release()


def load_gray_image(path: str) -> np.ndarray:
    """Grayscale uint8 image via PIL (no OpenCV dependency)."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("L"))


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(img, np.uint8)).save(path)


# ---------------------------------------------------------------------------
# Extraction drivers
# ---------------------------------------------------------------------------

def extract_board(frames: Iterable[tuple], opts: BoardExtractorOptions,
                  fps: float = 0.0, device=None) -> CornerDataset:
    """Detect board corners on an iterable of (time_s, gray) frames."""
    if opts.backend != "native":
        raise NotImplementedError(f"the {opts.backend!r} detection backend is not ported "
                                  "(ROADMAP.md queue 1, item 10)")
    detect = make_native_detector(opts, device)
    board = boards_mod.make_board(opts.board_type, opts.squares_x, opts.squares_y,
                                  opts.square_length, opts.marker_length)
    times, all_ids, all_pts = [], [], []
    shape = None
    for t, gray in frames:
        shape = gray.shape
        ids, pts = detect(gray)
        times.append(t)
        all_ids.append(np.asarray(ids, np.int64))
        all_pts.append(np.asarray(pts, np.float64).reshape(-1, 2))

    P = board.num_points
    V = len(times)
    pts2d = np.zeros((V, P, 2), np.float64)
    valid = np.zeros((V, P), bool)
    for v, (ids, pts) in enumerate(zip(all_ids, all_pts)):
        keep = ids < P
        pts2d[v, ids[keep]] = pts[keep]
        valid[v, ids[keep]] = True
    image_size = (shape[1], shape[0]) if shape is not None else (0, 0)
    if fps == 0.0 and len(times) > 1:
        dts = np.diff(times)
        fps = 1.0 / float(np.median(dts[dts > 0])) if (np.asarray(dts) > 0).any() else 0.0
    return CornerDataset(times=np.asarray(times), points2d=pts2d, valid=valid,
                         board_points=board.points, image_size=image_size, fps=fps)


def extract_board_from_video(video_path: str, opts: BoardExtractorOptions,
                             device=None) -> CornerDataset:
    return extract_board(iter_video_frames(video_path, opts.downsample_factor), opts,
                         device=device)


def extract_board_from_image_folder(folder: str, fps: float,
                                    opts: BoardExtractorOptions,
                                    device=None) -> CornerDataset:
    """Image-folder path (board_extractor.cc:268-383); frame time = k/fps."""
    files = sorted(os.listdir(folder))
    files = [f for f in files if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))]

    def gen():
        for k, fname in enumerate(files):
            img = load_gray_image(os.path.join(folder, fname))
            if opts.downsample_factor and opts.downsample_factor != 1.0:
                s = int(opts.downsample_factor)
                img = img[::s, ::s]
            yield k / fps, img

    return extract_board(gen(), opts, fps=fps, device=device)
