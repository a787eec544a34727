"""Board corner extraction from frames, videos and image folders.

Port of ``core/board_extractor.py`` of the JAX package (the reference's
BoardExtractor and board-PNG generator). ``extract_board`` runs the
native detectors on (time, gray) frames on ``device`` (default
``"cuda"``) and assembles the statically-shaped ``CornerDataset`` the
calibration stages consume:

* charuco (default): the batched video path (``detect/video.py``), blocks
  of ``batch_frames`` frames, when ``batched_video``; else one
  ``detect/charuco.py`` call per frame;
* radon (plain checkerboard): ``detect/checkerboard.py`` per frame;
* apriltag (Kalibr aprilgrid): ``detect/quads.py`` with the tag36h11
  family per frame.

The OpenCV backend (``backend="opencv"``, the reference's own detectors)
and video decoding import cv2 when they are used, and raise a clear error
without it; image folders are read with PIL.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, Tuple

import numpy as np

from openimucameracalibrator_torch.detect import aruco_dict as adict_mod
from openimucameracalibrator_torch.detect import charuco as charuco_mod
from openimucameracalibrator_torch.detect import checkerboard as checker_mod
from openimucameracalibrator_torch.detect import quads as quads_mod
from openimucameracalibrator_torch.detect import render as render_mod
from openimucameracalibrator_torch.models import boards as boards_mod
from openimucameracalibrator_torch.utils import precision
from openimucameracalibrator_torch.utils.types import CornerDataset


@dataclasses.dataclass
class BoardExtractorOptions:
    board_type: str = "charuco"
    squares_x: int = 10
    squares_y: int = 8
    square_length: float = 0.04
    marker_length: float = 0.03
    aruco_dict: str = "DICT_ARUCO_ORIGINAL"  # board_extractor.cc:46 default
    downsample_factor: float = 1.0  # resize 1/f (board_extractor.cc:414-430)
    backend: str = "native"  # "native" | "opencv"
    dictionary: object = None  # explicit ArucoDictionary override
    verbose: bool = False
    # Batched video pipeline (detect/video.py) for the native charuco path:
    # frames in F-frame blocks, the pixel stages batched on the device,
    # decode overlapped on a background thread. Other boards and the
    # OpenCV backend detect frame by frame.
    batched_video: bool = True
    batch_frames: int = 32
    # Detector-parameter config file (OpenCV-YAML or json) — the
    # reference's --aruco_detector_params / charuco_detector_params.yml
    # (src/utils/utils.cc:43-75); parsed by detect/params.py.
    detector_params_path: str = ""


def _native_dictionary(opts: BoardExtractorOptions) -> adict_mod.ArucoDictionary:
    if opts.dictionary is not None:
        return opts.dictionary
    if opts.aruco_dict.upper() in ("DICT_ARUCO_ORIGINAL", "ARUCO_ORIGINAL"):
        return adict_mod.aruco_original_dictionary()
    if opts.aruco_dict.upper() in ("DICT_APRILTAG_36H11", "TAG36H11"):
        return adict_mod.tag36h11_dictionary()
    raise ValueError(f"unknown dictionary {opts.aruco_dict!r} for native backend")


def _detector_params(opts: BoardExtractorOptions, image_size=None):
    """Parsed detector-parameter file, or None when not configured."""
    if not opts.detector_params_path:
        return None
    from openimucameracalibrator_torch.detect import params as params_mod

    return params_mod.load_detector_params(opts.detector_params_path,
                                           image_size=image_size)


def _charuco_spec(opts: BoardExtractorOptions) -> charuco_mod.CharucoBoardSpec:
    return charuco_mod.CharucoBoardSpec(opts.squares_x, opts.squares_y, opts.square_length,
                                        opts.marker_length, _native_dictionary(opts))


def make_native_detector(opts: BoardExtractorOptions, device=None):
    """detect(gray) -> (ids, corners_px) using the in-house stack on
    ``device`` (default ``"cuda"``)."""
    bt = boards_mod.BoardType(opts.board_type.lower())
    device = precision.resolve_device(device)
    dp = _detector_params(opts)
    if bt == boards_mod.BoardType.CHARUCO:
        spec = _charuco_spec(opts)
        copts = dp.charuco if dp else None
        return lambda g: charuco_mod.detect_charuco(g, spec, copts, device=device)
    if bt == boards_mod.BoardType.RADON:
        return lambda g: checker_mod.detect_checkerboard(g, opts.squares_x, opts.squares_y,
                                                         device=device)

    # Kalibr-style aprilgrids always use the tag36h11 family
    # (board_extractor.cc:226-232, resource/kalibr_apriltag.yaml).
    dictionary = (opts.dictionary if opts.dictionary is not None
                  else adict_mod.tag36h11_dictionary())

    def detect_april(gray):
        mids, mcorners = quads_mod.detect_markers(gray, dictionary, dp.marker if dp else None,
                                                  device=device)
        # Marker-image corner j (TL,TR,BR,BL) maps to aprilgrid board corner
        # 4*t + [3,2,1,0][j] (board +y up; see models/boards.py::apriltag_board
        # and detect/render.py::render_aprilgrid).
        board_c = (3, 2, 1, 0)
        ids, pts = [], []
        for t, cs in zip(mids, mcorners):
            for j in range(4):
                ids.append(4 * int(t) + board_c[j])
                pts.append(cs[j])
        return (np.asarray(ids, np.int64) if ids else np.zeros((0,), np.int64),
                np.asarray(pts) if pts else np.zeros((0, 2)))

    return detect_april


# ---------------------------------------------------------------------------
# Optional OpenCV backend (cross-validation / video decode)
# ---------------------------------------------------------------------------

def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (the cv2 module), which is not installed; "
                          "feed extract_board in-memory (time, gray) frames, or PNG folders "
                          "(read with PIL), instead") from e
    return cv2


def _make_charuco_detector(opts: BoardExtractorOptions):
    cv2 = _cv2("the OpenCV detection backend")
    adict = cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, opts.aruco_dict))
    board = cv2.aruco.CharucoBoard(
        (opts.squares_x, opts.squares_y), opts.square_length, opts.marker_length,
        adict)
    params = cv2.aruco.CharucoParameters()
    det_params = cv2.aruco.DetectorParameters()
    det_params.cornerRefinementMethod = cv2.aruco.CORNER_REFINE_SUBPIX
    return cv2.aruco.CharucoDetector(board, params, det_params), board


def detect_charuco_cv(gray: np.ndarray, detector) -> Tuple[np.ndarray, np.ndarray]:
    """(corner ids (K,), corners (K, 2)) for one grayscale frame."""
    corners, ids, _, _ = detector.detectBoard(gray)
    if corners is None or ids is None or len(corners) == 0:
        return np.zeros((0,), np.int64), np.zeros((0, 2), np.float64)
    return ids.reshape(-1).astype(np.int64), corners.reshape(-1, 2).astype(np.float64)


def detect_radon_cv(gray: np.ndarray, opts: BoardExtractorOptions):
    """findChessboardCornersSB path (board_extractor.cc:205)."""
    cv2 = _cv2("the OpenCV detection backend")
    nx, ny = opts.squares_x - 1, opts.squares_y - 1
    found, corners = cv2.findChessboardCornersSB(
        gray, (nx, ny), flags=cv2.CALIB_CB_ACCURACY)
    if not found:
        return np.zeros((0,), np.int64), np.zeros((0, 2), np.float64)
    return np.arange(nx * ny, dtype=np.int64), corners.reshape(-1, 2).astype(np.float64)


def detect_apriltag_cv(gray: np.ndarray, detector):
    """Kalibr-style aprilgrid via cv2 aruco: tag t corner c -> id 4*t + c."""
    corners, ids, _ = detector.detectMarkers(gray)
    if ids is None or len(ids) == 0:
        return np.zeros((0,), np.int64), np.zeros((0, 2), np.float64)
    out_ids, out_pts = [], []
    for tag_id, cs in zip(ids.reshape(-1), corners):
        for c in range(4):
            out_ids.append(4 * int(tag_id) + c)
            out_pts.append(cs[0, c])
    return np.asarray(out_ids, np.int64), np.asarray(out_pts, np.float64)


def make_opencv_detector(opts: BoardExtractorOptions):
    cv2 = _cv2("the OpenCV detection backend")
    bt = boards_mod.BoardType(opts.board_type.lower())
    if bt == boards_mod.BoardType.CHARUCO:
        detector, _ = _make_charuco_detector(opts)
        return lambda g: detect_charuco_cv(g, detector)
    if bt == boards_mod.BoardType.RADON:
        return lambda g: detect_radon_cv(g, opts)
    adict = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11)
    det_params = cv2.aruco.DetectorParameters()
    det_params.cornerRefinementMethod = cv2.aruco.CORNER_REFINE_SUBPIX
    detector = cv2.aruco.ArucoDetector(adict, det_params)
    return lambda g: detect_apriltag_cv(g, detector)


# ---------------------------------------------------------------------------
# Frame sources
# ---------------------------------------------------------------------------

def iter_video_frames(video_path: str, downsample: float = 1.0) -> Iterator[tuple]:
    """(timestamp_s, gray frame) per video frame (board_extractor.cc:385-430).

    Tolerates up to 500 consecutive bad reads like the reference
    (:415-418). Requires cv2 for decode.
    """
    cv2 = _cv2(f"decoding the video {video_path}")

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
    """Detect board corners on an iterable of (time_s, gray) frames on
    ``device`` (default ``"cuda"``)."""
    board = boards_mod.make_board(opts.board_type, opts.squares_x, opts.squares_y,
                                  opts.square_length, opts.marker_length)
    times, all_ids, all_pts = [], [], []
    shape = None
    bt = boards_mod.BoardType(opts.board_type.lower())
    if (opts.batched_video and opts.backend == "native"
            and bt == boards_mod.BoardType.CHARUCO):
        from openimucameracalibrator_torch.detect import video as video_mod

        device = precision.resolve_device(device)
        spec = _charuco_spec(opts)
        dp = _detector_params(opts)
        vopts = video_mod.VideoDetectorOptions(batch_frames=opts.batch_frames)
        if dp is not None:
            vopts.marker = dp.marker
            vopts.subpix_win = dp.charuco.subpix_win
            vopts.max_residual_px = dp.charuco.max_residual_px
            vopts.min_markers = dp.charuco.min_markers
            vopts.local_markers = dp.charuco.local_markers

        def tap(it):
            nonlocal shape
            for t, g in it:
                shape = g.shape
                yield t, g

        for t, ids, pts in video_mod.detect_charuco_video(tap(frames), spec, vopts,
                                                          device=device):
            times.append(t)
            all_ids.append(np.asarray(ids, np.int64))
            all_pts.append(np.asarray(pts, np.float64).reshape(-1, 2))
    else:
        if opts.backend == "opencv":
            detect = make_opencv_detector(opts)
        elif opts.backend == "native":
            detect = make_native_detector(opts, device)
        else:
            raise ValueError(f"unknown detection backend {opts.backend!r}")
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


def render_charuco_board_image(opts: BoardExtractorOptions, px_per_square: int = 100,
                               margin_px: int = 20) -> np.ndarray:
    """Printable board PNG (create_charuco_board.cc:30-67), native renderer."""
    return render_mod.render_charuco_board(
        _native_dictionary(opts), opts.squares_x, opts.squares_y,
        opts.square_length, opts.marker_length, px_per_square, margin_px)
