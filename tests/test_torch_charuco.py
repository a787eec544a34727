"""Port parity: charuco detection (detect/quads.py, charuco.py, video.py,
params.py, the block mode of detect/kernels.py, core/board_extractor.py's
charuco and apriltag paths, the create-charuco-board tool).

The JAX package's ``detect/quads.py`` does not parse (the docstring of
``_fit_quads`` opened at :128 swallows the comment block below it) and
``_fit_quads`` returns ``quad[ok]`` where its caller unpacks ``quad, ok``.
``_reference_quads`` loads it from its source text with two in-memory
edits, after checking that each edited line reads as expected: line 131
closes the docstring, line 195 returns ``quad, ok``. The file is never
written. The loaded module stands in for ``openimucameracalibrator_tpu.
detect.quads`` while this module's tests run (a module fixture), so the
JAX ``charuco``, ``video``, ``params`` and ``core/board_extractor`` import;
the fixture takes them all out of ``sys.modules`` again afterwards.

Inputs: warped renders of the 10x8 charuco board at 540x660, as in
tests/test_video_detect.py, made with numpy from a seed. Both packages see
the same uint8 frames on the CPU. Tolerances: the same quads (host numpy
in both); the same ids and corners within 1e-3 px (float32 image
arithmetic summed in other orders); the block-mode response within 1e-5
of the largest response. Also the truth bars of tests/test_video_detect.py
and tests/test_board_extractor.py:86-113.
"""

import dataclasses
import importlib
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openimucameracalibrator_tpu.detect as j_detect_pkg
from openimucameracalibrator_torch.apps import misc_tools as t_misc
from openimucameracalibrator_torch.core import board_extractor as t_be
from openimucameracalibrator_torch.detect import aruco_dict as t_adict
from openimucameracalibrator_torch.detect import charuco as t_charuco
from openimucameracalibrator_torch.detect import image as t_image
from openimucameracalibrator_torch.detect import kernels as t_kernels
from openimucameracalibrator_torch.detect import params as t_params
from openimucameracalibrator_torch.detect import quad_kernels as t_quad_kernels
from openimucameracalibrator_torch.detect import quads as t_quads
from openimucameracalibrator_torch.detect import render as t_render
from openimucameracalibrator_torch.detect import video as t_video
from openimucameracalibrator_torch.ops import pnp as t_pnp
from openimucameracalibrator_tpu.detect import image as j_image

PX_TOL = 1e-3
QUADS = "openimucameracalibrator_tpu.detect.quads"
DEPENDENTS = tuple(f"openimucameracalibrator_tpu.{m}" for m in (
    "detect.charuco", "detect.video", "detect.params", "core.board_extractor"))
EDITS = {131: ("    (One set of numpy ops", '    (One set of numpy ops)."""'),
         195: ("    return quad[ok]", "    return quad, ok")}
DICT = t_adict.aruco_original_dictionary(64)
SPEC = t_charuco.CharucoBoardSpec(10, 8, 0.04, 0.03, DICT)
OPENCV_YAML = """%YAML:1.0
nmarkers: 1024
adaptiveThreshWinSize: 21
adaptiveThreshConstant: 5
minMarkerPerimeterRate: 0.01
maxMarkerPerimeterRate: 2.0
polygonalApproxAccuracyRate: 0.05
cornerRefinementMethod: 1 # 1->subpix 3->apriltag
cornerRefinementWinSize: 6
markerBorderBits: 1
perspectiveRemovePixelPerCell: 21
errorCorrectionRate: 0.6
customKey: 3
"""


def _reference_quads():
    """The JAX package's detect/quads.py, loaded from its source text with
    the two in-memory edits of EDITS (each line checked before it is
    edited; the file is only read) and registered in ``sys.modules``
    (its dataclass looks itself up there)."""
    path = os.path.join(os.path.dirname(j_detect_pkg.__file__), "quads.py")
    with open(path) as f:
        lines = f.read().split("\n")
    for no, (want, repl) in EDITS.items():
        assert lines[no - 1] == want, (no, lines[no - 1])
        lines[no - 1] = repl
    mod = types.ModuleType(QUADS)
    mod.__file__ = path
    sys.modules[QUADS] = mod
    exec(compile("\n".join(lines), path, "exec"), mod.__dict__)
    return mod


@pytest.fixture(scope="module")
def jx():
    """The JAX charuco stack with the repaired quads module, for this
    module's tests only."""
    names = (QUADS,) + DEPENDENTS
    saved = {n: sys.modules.get(n) for n in names}
    try:
        mods = types.SimpleNamespace(quads=_reference_quads(), **{
            n.rsplit(".", 1)[1]: importlib.import_module(n) for n in DEPENDENTS})
        yield mods
    finally:
        for n in names:
            if saved[n] is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = saved[n]
            parent, attr = n.rsplit(".", 1)
            if saved[n] is None and hasattr(sys.modules[parent], attr):
                delattr(sys.modules[parent], attr)


def _homography(src, dst):
    f64 = dict(dtype=torch.float64)
    H = t_pnp.homography_dlt(torch.as_tensor(src[None], **f64), torch.as_tensor(dst[None], **f64),
                             torch.ones((1, src.shape[0]), **f64))[0].numpy()
    return H / H[2, 2]


def _apply_h(H, pts):
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    return ph[:, :2] / ph[:, 2:3]


@pytest.fixture(scope="module")
def frames():
    """Three warped views of the rendered 10x8 board (540x660) and their
    homographies (tests/test_video_detect.py::_make_frames, seed 3)."""
    img = t_render.render_charuco_board(DICT, 10, 8, 0.04, 0.03, px_per_square=60, margin_px=30)
    h0, w0 = img.shape
    rng = np.random.default_rng(3)
    src = np.float64([[0, 0], [w0, 0], [w0, h0], [0, h0]])
    out, Hs = [], []
    for k in range(3):
        dst = np.float64([[50, 40], [w0 - 60, 45], [w0 - 40, h0 - 50], [55, h0 - 35]]) \
            + rng.uniform(-40, 40, (4, 2))
        H = _homography(src, dst)
        out.append((0.1 * k, np.asarray(t_render.warp_image(img, H, (h0, w0)), np.uint8)))
        Hs.append(H)
    return img, out, Hs


def _truth(H, ids):
    chess_px = 30.0 + (np.stack([ids % 9, ids // 9], -1) + 1) * 60.0 - 0.5
    return _apply_h(H, chess_px)


def _same_detection(got, want, tol=PX_TOL):
    (ids, pts), (ids_j, pts_j) = got, want
    np.testing.assert_array_equal(ids, np.asarray(ids_j))
    np.testing.assert_allclose(pts, np.asarray(pts_j), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def jax_single(jx, frames):
    """The JAX detect_charuco on each frame, and what its detect_markers
    call returned there (recorded on the way, so the marker stage needs no
    run of its own)."""
    spec = jx.charuco.CharucoBoardSpec(10, 8, 0.04, 0.03,
                                       jx.charuco.aruco_original_dictionary(64))
    real, markers = jx.quads.detect_markers, []

    def recording(*args, **kw):
        markers.append(real(*args, **kw))
        return markers[-1]

    jx.quads.detect_markers = recording
    try:
        out = [jx.charuco.detect_charuco(g.astype(np.float32), spec) for _, g in frames[1]]
    finally:
        jx.quads.detect_markers = real
    return out, markers


def _canonical(q):
    """Quads (n, 4, 2) sorted by their coordinates."""
    flat = q.reshape(q.shape[0], -1)
    return q[np.lexsort(flat.T[::-1])]


def test_find_quad_candidates_matches_jax(jx, frames):
    """The same quads from the same mask. The masks themselves agree but
    for pixels whose value sits within float32 rounding of its window mean
    minus c (the window sums add in another order): 2 of 356,400 here.
    The port orders components of equal area by label (a stable sort, the
    order the card's quad kernel reproduces); the JAX package leaves that
    order to numpy's default sort, which is not stable, so the quads are
    compared as sets. The cut at max_candidates does not act on these
    masks, so both sets are every fitted component."""
    from scipy import ndimage

    opts = t_quads.MarkerDetectorOptions()
    for _, g in frames[1]:
        mask = t_image.adaptive_threshold(torch.as_tensor(g, dtype=torch.float32)).numpy()
        mask_j = np.asarray(j_image.adaptive_threshold(jnp.asarray(g, jnp.float32)))
        assert np.mean(mask != mask_j) < 1e-4
        labels, n = ndimage.label(mask)
        areas = np.bincount(labels.ravel(), minlength=n + 1)[1:]
        kept = ((areas >= opts.min_area_px) & (areas <= opts.max_area_frac * mask.size)).sum()
        assert kept <= opts.max_candidates
        q = t_quads.find_quad_candidates(mask, opts)
        q_j = jx.quads.find_quad_candidates(mask, jx.quads.MarkerDetectorOptions())
        assert q.shape[0] >= 40
        np.testing.assert_array_equal(_canonical(q), _canonical(np.asarray(q_j)))
    assert t_quads.find_quad_candidates(np.zeros((40, 50), bool), opts).shape == (0, 4, 2)


@pytest.mark.parametrize("rot", [0, 1, 2, 3])
def test_detect_markers_matches_jax(jx, rot):
    """A marker in white (tests/test_board_extractor.py:62-83) at each
    rotation against the JAX detector."""
    big = np.full((240, 260), 255, np.uint8)
    big[70:150, 90:170] = np.rot90(t_render.render_marker(DICT, 23, 80), rot)
    jdict = jx.charuco.aruco_original_dictionary(64)
    ids, corners = t_quads.detect_markers(big, DICT, device="cpu")
    ids_j, corners_j = jx.quads.detect_markers(big.astype(np.float32), jdict)
    _same_detection((ids, corners), (ids_j, corners_j))
    placed = np.array([[89.5, 69.5], [169.5, 69.5], [169.5, 149.5], [89.5, 149.5]])
    assert list(ids) == [23]
    np.testing.assert_allclose(corners[0][0], placed[(0 - rot) % 4], atol=0.25)


def test_detect_markers_on_board_views_matches_jax(jax_single, frames):
    """The marker stage of detect_charuco (the board's 40-id subset of the
    dictionary) on each view, against the JAX call's output."""
    sub, _ = t_adict.subset_dictionary(DICT, np.arange(40))
    for (_, g), want in zip(frames[1], jax_single[1]):
        ids, corners = t_quads.detect_markers(g, sub, device="cpu")
        assert len(ids) >= 30
        _same_detection((ids, corners), want)


def test_detect_charuco_matches_jax(jax_single, frames):
    img, fr, Hs = frames
    for (_, g), H, want in zip(fr, Hs, jax_single[0]):
        ids, pts = t_charuco.detect_charuco(g, SPEC, device="cpu")
        _same_detection((ids, pts), want)
        err = np.linalg.norm(pts - _truth(H, ids), axis=1)
        assert len(ids) >= 55 and err.mean() < 0.2 and err.max() < 0.5
    # the unwarped render: every corner (tests/test_board_extractor.py:86-95)
    ids, pts = t_charuco.detect_charuco(img, SPEC, device="cpu")
    assert len(ids) == 63
    assert np.linalg.norm(pts - _truth(np.eye(3), ids), axis=1).max() < 0.25


@pytest.fixture(scope="module")
def jax_video(jx, frames):
    spec = jx.charuco.CharucoBoardSpec(10, 8, 0.04, 0.03,
                                       jx.charuco.aruco_original_dictionary(64))
    return list(jx.video.detect_charuco_video(iter(frames[1]), spec,
                                              jx.video.VideoDetectorOptions(batch_frames=2)))


@pytest.mark.parametrize("pack", [True, False])
def test_detect_charuco_video_matches_jax(jax_video, jax_single, frames, pack):
    """Batches of 2 over 3 frames (a padded tail block), the mask fetched
    packed and unpacked; the CPU route never launches the card's quad
    kernel."""
    _, fr, Hs = frames
    opts = t_video.VideoDetectorOptions(batch_frames=2, pack_mask=pack)
    k3_launches = t_quad_kernels.quad_candidates_block.launches
    got = list(t_video.detect_charuco_video(iter(fr), SPEC, opts, device="cpu"))
    assert t_quad_kernels.quad_candidates_block.launches == k3_launches == 0
    assert len(got) == len(fr)
    for (t_in, _), (t, ids, pts), (t_j, ids_j, pts_j), H, single in zip(fr, got, jax_video, Hs,
                                                                      jax_single[0]):
        assert t == t_j == t_in
        _same_detection((ids, pts), (ids_j, pts_j))
        err = np.linalg.norm(pts - _truth(H, ids), axis=1)
        assert len(ids) >= 55 and err.mean() < 0.25 and err.max() < 0.6
        common = np.intersect1d(ids, single[0])
        assert len(common) >= 0.95 * len(single[0])


def test_empty_frames_give_empty_results(frames):
    _, fr, _ = frames
    blank = np.full_like(fr[0][1], 128)
    ids, pts = t_charuco.detect_charuco(blank, SPEC, device="cpu")
    assert ids.shape == (0,) and pts.shape == (0, 2)
    assert t_quads.detect_markers(blank, DICT, device="cpu")[0].shape == (0,)
    got = list(t_video.detect_charuco_video(iter([fr[0], (0.5, blank), fr[1]]), SPEC,
                                            t_video.VideoDetectorOptions(batch_frames=3),
                                            device="cpu"))
    assert [len(g[1]) >= 55 for g in got] == [True, False, True]
    assert got[1][1].shape == (0,) and got[1][2].shape == (0, 2)


def test_detector_params_match_jax(jx, tmp_path):
    yml, js = tmp_path / "p.yml", tmp_path / "p.json"
    yml.write_text(OPENCV_YAML)
    js.write_text(json.dumps({"adaptiveThreshConstant": 9, "cornerRefinementWinSize": 3}))
    for path in (yml, js):
        assert t_params.parse_opencv_yaml(str(path)) == jx.params.parse_opencv_yaml(str(path))
        for size in (None, (960, 540)):
            dp = t_params.load_detector_params(str(path), image_size=size)
            dp_j = jx.params.load_detector_params(str(path), image_size=size)
            assert dataclasses.asdict(dp.marker) == dataclasses.asdict(dp_j.marker)
            assert (dataclasses.asdict(dp.charuco) == dataclasses.asdict(dp_j.charuco))
            assert (dp.extras, dp.unknown) == (dp_j.extras, dp_j.unknown)
    assert t_params.load_detector_params(str(yml)).unknown == {"customKey": 3}
    with pytest.raises(FileNotFoundError):
        t_params.load_detector_params(str(tmp_path / "none.yml"))


@pytest.mark.parametrize("batched", [True, False])
def test_extract_board_charuco_matches_jax(jx, frames, batched):
    _, fr, _ = frames
    kw = dict(squares_x=10, squares_y=8, batched_video=batched, batch_frames=2)
    ds = t_be.extract_board(iter(fr), t_be.BoardExtractorOptions(dictionary=DICT, **kw),
                            device="cpu")
    ds_j = jx.board_extractor.extract_board(iter(fr), jx.board_extractor.BoardExtractorOptions(
        dictionary=jx.charuco.aruco_original_dictionary(64), **kw))
    np.testing.assert_array_equal(ds.valid, ds_j.valid)
    np.testing.assert_allclose(ds.points2d, ds_j.points2d, rtol=0, atol=PX_TOL)
    np.testing.assert_array_equal(ds.times, ds_j.times)
    np.testing.assert_array_equal(ds.board_points, ds_j.board_points)
    assert (ds.image_size, ds.fps) == (ds_j.image_size, ds_j.fps)
    assert ds.valid.sum(1).min() >= 55


def test_extract_board_apriltag_matches_jax(jx):
    d = t_adict.random_dictionary(8, marker_size=6, seed=3)
    d_j = jx.charuco.adict_sub.random_dictionary(8, marker_size=6, seed=3)
    img = t_render.render_aprilgrid(d, 3, 2, tag_px=80, spacing_ratio=0.3, margin_px=30)
    kw = dict(board_type="apriltag", squares_x=3, squares_y=2, square_length=0.088,
              marker_length=0.3)
    ds = t_be.extract_board([(0.0, img)], t_be.BoardExtractorOptions(dictionary=d, **kw),
                            device="cpu")
    ds_j = jx.board_extractor.extract_board(
        [(0.0, img)], jx.board_extractor.BoardExtractorOptions(dictionary=d_j, **kw))
    assert ds.valid.sum() == 24
    np.testing.assert_array_equal(ds.valid, ds_j.valid)
    np.testing.assert_allclose(ds.points2d, ds_j.points2d, rtol=0, atol=PX_TOL)


def test_charuco_board_image_matches_jax(jx, tmp_path):
    opts = t_be.BoardExtractorOptions(squares_x=5, squares_y=4)
    img = t_be.render_charuco_board_image(opts, 40)
    img_j = jx.board_extractor.render_charuco_board_image(
        jx.board_extractor.BoardExtractorOptions(squares_x=5, squares_y=4), 40)
    np.testing.assert_array_equal(img, img_j)
    out = tmp_path / "board.png"
    t_misc.board_main(["--output_path", str(out), "--squares_x", "5", "--squares_y", "4",
                       "--px_per_square", "40"])
    np.testing.assert_array_equal(t_be.load_gray_image(str(out)), img)


def test_block_plain_response_matches_jax(frames):
    """The block mode's plain version against the JAX video path's
    ``vmap(_corner_response_xla)`` on the block, and against the 2-D plain
    response frame by frame."""
    block = np.stack([g for _, g in frames[1]]).astype(np.float32)
    resp = t_kernels.corner_response_block_plain(torch.as_tensor(block)).numpy()
    want = np.asarray(jax.vmap(lambda g: j_image._corner_response_xla(g, 6))(jnp.asarray(block)))
    assert resp.shape == block.shape
    np.testing.assert_allclose(resp, want, rtol=0, atol=1e-5 * np.abs(want).max())
    for f in range(block.shape[0]):
        np.testing.assert_array_equal(
            resp[f], t_image.corner_response(torch.as_tensor(block[f])).numpy())
    np.testing.assert_array_equal(resp, t_image.corner_response(torch.as_tensor(block)).numpy())


def test_charuco_entry_points_default_to_cuda(frames, monkeypatch):
    """Without a CUDA device the charuco entry points raise unless given
    device="cpu"; without cv2, video decoding and the OpenCV backend say
    that they need it."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    g = frames[1][0][1]
    calls = [lambda: t_charuco.detect_charuco(g, SPEC),
             lambda: t_quads.detect_markers(g, DICT),
             lambda: list(t_video.detect_charuco_video(iter([(0.0, g)]), SPEC)),
             lambda: t_be.extract_board([(0.0, g)], t_be.BoardExtractorOptions())]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setitem(sys.modules, "cv2", None)  # as where cv2 is not installed
    with pytest.raises(ImportError, match="cv2"):
        list(t_be.iter_video_frames("missing.MP4"))
    with pytest.raises(ImportError, match="cv2"):
        t_be.extract_board([(0.0, g)], t_be.BoardExtractorOptions(backend="opencv"),
                           device="cpu")
