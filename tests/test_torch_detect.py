"""Port parity: detection (detect/image.py, detect/kernels.py,
detect/checkerboard.py, the numpy copies) and the frame renderer.

Inputs are made with numpy from a seed and go through the JAX function
and its counterpart in the port on the CPU. Detection is float32 by
construction in both packages (``detect/image.py`` casts to float32); the
renderer runs in float64.

* K2 (corner response + NMS): the port's plain version against the JAX
  package's XLA path and its Pallas kernel in interpret mode, with the bars
  of tests/test_pallas_detect.py: response within 2e-5 of the largest
  response, the keep mask agreeing on >= 0.999 of the pixels and exactly
  wherever |resp - local max| > 1e-4 of the largest response.
* Candidates: the same points, scores within 2e-5 of the largest, the same
  order wherever adjacent scores differ by more than 1e-5 of the largest;
  on a clean render with exact ties, lower flat index first.
* Every function of image.py: float32 rounding (rtol 1e-5 plus 1e-6 of
  the largest value), refined corners within 1e-3 px.
* detect_checkerboard: the same ids and corners within 1e-3 px, plus the
  truth bars of tests/test_board_extractor.py:115-135 (that file cannot
  collect: it imports detect/quads.py, which does not parse).
* Rendering: frames within 1 DN of the JAX package's, given the same
  per-row poses.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.detect import checkerboard as t_checker
from openimucameracalibrator_torch.detect import image as t_image
from openimucameracalibrator_torch.detect import kernels as t_kernels
from openimucameracalibrator_torch.detect import render as t_render
from openimucameracalibrator_torch.utils import recorded as t_recorded
from openimucameracalibrator_tpu.detect import checkerboard as j_checker
from openimucameracalibrator_tpu.detect import image as j_image
from openimucameracalibrator_tpu.detect import pallas_kernels as j_kernels
from openimucameracalibrator_tpu.detect import render as j_render
from openimucameracalibrator_tpu.ops import pnp as j_pnp
from openimucameracalibrator_tpu.utils import recorded as j_recorded
from openimucameracalibrator_tpu.utils import synthetic as j_synthetic

RESP_TOL = 2e-5  # of max|resp|
ORDER_TOL = 1e-5  # of max|resp|: closer scores may swap


def _board(warp=False):
    """The 8x6 checkerboard of tests/test_board_extractor.py, plain or
    under its homography; returns (uint8 image, H or None)."""
    img = j_render.render_checkerboard(8, 6, px_per_square=50, margin_px=25)
    if not warp:
        return img, None
    h0, w0 = img.shape
    src = np.float64([[0, 0], [w0, 0], [w0, h0], [0, h0]])
    dst = np.float64([[30, 20], [w0 - 50, 40], [w0 - 20, h0 - 30], [45, h0 - 15]])
    H = np.array(j_pnp.homography_dlt(jnp.asarray(src[None]), jnp.asarray(dst[None]),
                                      jnp.ones((1, 4))))[0]
    H = H / H[2, 2]
    return j_render.warp_image(img, H, (h0, w0)), H


def _noisy(img, seed=0, std=2.0):
    return (img + np.random.default_rng(seed).normal(0, std, img.shape)).astype(np.float32)


def _keep_bars(keep, resp_ref, keep_ref, local_max):
    scale = float(np.max(np.abs(resp_ref))) or 1.0
    keep, keep_ref = np.asarray(keep) > 0, np.asarray(keep_ref) > 0
    assert np.mean(keep == keep_ref) >= 0.999
    clear = np.abs(resp_ref - local_max) > 1e-4 * scale
    np.testing.assert_array_equal(keep[clear], keep_ref[clear])


def _xla_nms(resp):
    local_max = np.asarray(jax.lax.reduce_window(jnp.asarray(resp), -jnp.inf, jax.lax.max,
                                                 (9, 9), (1, 1), "SAME"))
    return local_max, resp >= local_max


# ---------------------------------------------------------------------------
# Tables and K2's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [4, 6])
def test_prototype_bank_and_tap_tables_equal_jax(radius):
    np.testing.assert_array_equal(t_image._prototype_bank(radius), j_image._prototype_bank(radius))
    for a, b in zip(t_kernels._tap_tables(radius), j_kernels._tap_tables(radius)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("radius", [1, 3, 6, 9])
def test_packed_taps_unpack_to_the_jax_bank(radius):
    """The kernel's packed weights (loop order dx, quadrant, dy, taps chosen
    by the membership rule of csrc/corner_nms.cu) put back on the
    (2r+1)^2 grid give the JAX package's prototype bank exactly."""
    w = t_kernels._packed_taps(radius)
    assert w.dtype == np.float32 and w.shape == (8 * radius * radius,)
    dense = np.zeros((8, 2 * radius + 1, 2 * radius + 1), np.float32)
    it = iter(w)
    for dx in range(-radius, radius + 1):
        for q in range(8):
            for dy in range(-radius, radius + 1):
                if t_kernels._in_quad(q, dy, dx):
                    dense[q, dy + radius, dx + radius] = next(it)
    assert next(it, None) is None
    np.testing.assert_array_equal(dense.reshape(2, 4, 2 * radius + 1, 2 * radius + 1),
                                  j_image._prototype_bank(radius))


@pytest.mark.parametrize("warp", [False, True])
def test_plain_response_nms_matches_xla(warp):
    img = _noisy(_board(warp)[0])
    resp_ref = np.asarray(j_image._corner_response_xla(jnp.asarray(img), 6))
    resp, keep = t_kernels.corner_response_nms_plain(torch.as_tensor(img), 6, 4)
    assert resp.dtype == keep.dtype == torch.float32
    scale = float(resp_ref.max())
    np.testing.assert_allclose(resp.numpy(), resp_ref, rtol=0, atol=RESP_TOL * scale)
    local_max, keep_ref = _xla_nms(resp_ref)
    _keep_bars(keep.numpy(), resp_ref, keep_ref, local_max)


def test_plain_response_nms_matches_pallas_interpret():
    img = _noisy(_board(True)[0])[40:200, 60:260]  # 160 x 200: interpret mode is slow
    resp_ref, keep_ref = (np.asarray(a) for a in j_kernels.corner_response_nms(
        jnp.asarray(img), 6, 4, interpret=True))
    resp, keep = t_kernels.corner_response_nms_plain(torch.as_tensor(img), 6, 4)
    scale = float(resp_ref.max())
    np.testing.assert_allclose(resp.numpy(), resp_ref, rtol=0, atol=RESP_TOL * scale)
    local_max, _ = _xla_nms(resp_ref)
    _keep_bars(keep.numpy(), resp_ref, keep_ref, local_max)


def test_corner_response_dispatches_to_plain_on_cpu():
    img = _noisy(_board()[0])
    before = t_kernels.corner_response_nms.launches
    resp = t_image.corner_response(torch.as_tensor(img), 6)
    ref = np.asarray(j_image.corner_response(jnp.asarray(img), 6))
    np.testing.assert_allclose(resp.numpy(), ref, rtol=0, atol=RESP_TOL * float(ref.max()))
    assert t_kernels.corner_response_nms.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        t_kernels.corner_response_nms(torch.as_tensor(img))


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------

def test_candidates_match_jax_on_noisy_render():
    img = _noisy(_board(True)[0], seed=1)
    xy_j, s_j = (np.asarray(a) for a in j_image.find_corner_candidates(jnp.asarray(img)))
    xy_t, s_t = (a.numpy() for a in t_image.find_corner_candidates(torch.as_tensor(img)))
    n = int((s_j > 0).sum())
    assert n >= 35 and int((s_t > 0).sum()) == n
    assert {tuple(p) for p in xy_t[:n]} == {tuple(p) for p in xy_j[:n]}
    scale = float(s_j[0])
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=RESP_TOL * scale)
    # Same order wherever the scores are apart; near-equal ones may swap.
    for i in range(n):
        if (i == 0 or s_j[i - 1] - s_j[i] > ORDER_TOL * scale) and \
                (i == n - 1 or s_j[i] - s_j[i + 1] > ORDER_TOL * scale):
            np.testing.assert_array_equal(xy_t[i], xy_j[i])


def test_candidates_tie_order_follows_lower_flat_index():
    # jax.lax.top_k([1, 3, 3, 0, 3, 2], 4) -> indices [1, 2, 4, 5]
    resp = torch.tensor([[1.0, 3.0, 3.0], [0.0, 3.0, 2.0]])
    xy, s = t_kernels.top_candidates(resp, torch.ones_like(resp), 4, 0.0)
    np.testing.assert_array_equal(s.numpy(), [3, 3, 3, 2])
    np.testing.assert_array_equal(xy.numpy(), [[1, 0], [2, 0], [1, 1], [2, 1]])
    # A clean render has exact ties: the whole list equals JAX's, in order.
    img = _board()[0].astype(np.float32)
    xy_j, s_j = (np.asarray(a) for a in j_image.find_corner_candidates(jnp.asarray(img)))
    xy_t, s_t = (a.numpy() for a in t_image.find_corner_candidates(torch.as_tensor(img)))
    assert len(np.unique(s_j[s_j > 0])) < int((s_j > 0).sum())  # ties present
    np.testing.assert_array_equal(xy_t, xy_j)
    np.testing.assert_array_equal(s_t, s_j)


# ---------------------------------------------------------------------------
# Every function of image.py
# ---------------------------------------------------------------------------

def _image_case(name):
    img = _noisy(_board(True)[0], seed=2, std=3.0)
    ti, ji = torch.as_tensor(img), jnp.asarray(img)
    rng = np.random.default_rng(3)
    if name == "box_mean":
        return t_image.box_mean(ti, 10), j_image.box_mean(ji, 10)
    if name == "gradients":
        return (torch.stack(t_image.gradients(ti)), jnp.stack(j_image.gradients(ji)))
    if name == "bilinear_sample":
        u = rng.uniform(-3, img.shape[1] + 3, 500).astype(np.float32)
        v = rng.uniform(-3, img.shape[0] + 3, 500).astype(np.float32)
        return (t_image.bilinear_sample(ti, torch.as_tensor(u), torch.as_tensor(v)),
                j_image.bilinear_sample(ji, jnp.asarray(u), jnp.asarray(v)))
    if name == "sample_homography_grid":
        H = np.array([[120.0, 8.0, 60.0], [-5.0, 110.0, 40.0], [0.02, -0.01, 1.0]])
        return (t_image.sample_homography_grid(ti, torch.as_tensor(H), 7, 5, 3, 0.13),
                j_image.sample_homography_grid(ji, jnp.asarray(H), 7, 5, 3, 0.13))
    if name == "corner_refine_fields":
        return t_image.corner_refine_fields(ti, 5), j_image.corner_refine_fields(ji, 5)
    if name == "corner_response":
        return t_image.corner_response(ti, 6), j_image.corner_response(ji, 6)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["box_mean", "gradients", "bilinear_sample",
                                  "sample_homography_grid", "corner_refine_fields",
                                  "corner_response"])
def test_image_function_matches_jax(name):
    got, want = _image_case(name)
    want = np.asarray(want)
    assert got.dtype == {np.dtype("float32"): torch.float32,
                         np.dtype("float64"): torch.float64}[want.dtype]
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * scale)


def test_adaptive_threshold_matches_jax():
    img = _noisy(_board(True)[0], seed=4, std=3.0)
    got = t_image.adaptive_threshold(torch.as_tensor(img), 10, 7.0).numpy()
    want = np.asarray(j_image.adaptive_threshold(jnp.asarray(img), 10, 7.0))
    # Exact wherever the pixel is not within float32 rounding of the bar.
    margin = np.abs(img - (np.asarray(j_image.box_mean(jnp.asarray(img), 10)) - 7.0))
    clear = margin > 1e-3
    assert clear.mean() > 0.999
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("fields", [False, True])
def test_subpixel_refinement_matches_jax(fields):
    img, H = _board(True)
    img = _noisy(img, seed=5, std=1.0)
    truth = 25.0 + (np.stack(np.meshgrid(np.arange(7), np.arange(5)), -1).reshape(-1, 2)
                    + 1) * 50.0 - 0.5
    ph = np.c_[truth, np.ones(len(truth))] @ H.T
    truth = ph[:, :2] / ph[:, 2:]
    start = (truth + np.random.default_rng(6).uniform(-1.5, 1.5, truth.shape)).astype(np.float32)
    ti, ji = torch.as_tensor(img), jnp.asarray(img)
    if fields:
        got = t_image.refine_corners_from_fields(t_image.corner_refine_fields(ti), torch.as_tensor(start))
        want = j_image.refine_corners_from_fields(j_image.corner_refine_fields(ji), jnp.asarray(start))
    else:
        got = t_image.refine_corners_subpix(ti, torch.as_tensor(start))
        want = j_image.refine_corners_subpix(ji, jnp.asarray(start))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    assert np.abs(got.numpy() - truth).max() < 0.5  # it did converge onto the corners


# ---------------------------------------------------------------------------
# detect_checkerboard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warp", [False, True])
def test_detect_checkerboard_matches_jax(warp):
    img, H = _board(warp)
    ids_j, pts_j = j_checker.detect_checkerboard(img.astype(np.float32), 8, 6)
    t_checker.reset_phase_seconds()
    ids_t, pts_t = t_checker.detect_checkerboard(img, 8, 6, device="cpu")
    assert all(v > 0 for v in t_checker.phase_seconds.values())
    np.testing.assert_array_equal(ids_t, ids_j)
    assert len(ids_t) == 35
    np.testing.assert_allclose(pts_t, pts_j, rtol=0, atol=1e-3)
    gt = 25.0 + (np.stack([ids_t % 7, ids_t // 7], -1) + 1) * 50.0 - 0.5
    if warp:
        ph = np.c_[gt, np.ones(len(gt))] @ H.T
        assert np.linalg.norm(pts_t - ph[:, :2] / ph[:, 2:], axis=1).mean() < 0.25
    else:
        assert np.linalg.norm(pts_t - gt, axis=1).max() < 0.2


def test_numpy_copies_render_the_same():
    np.testing.assert_array_equal(t_render.render_checkerboard(10, 8, 64, 32),
                                  j_render.render_checkerboard(10, 8, 64, 32))
    np.testing.assert_array_equal(t_recorded.charuco_texture().image,
                                  j_recorded.charuco_texture().image)
    _, H = _board(True)
    img = j_render.render_checkerboard(8, 6, 50, 25)
    np.testing.assert_array_equal(t_render.warp_image(img, H, img.shape),
                                  j_render.warp_image(img, H, img.shape))


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

CAM = [437.13 / 6, 489.07 / 6, 270.87 / 6, -1.4386e-06 * 36]  # 160 x 90
SIZE = (160, 90)


def _jax_pose():
    return j_synthetic.sinusoid_trajectory(
        jax.random.PRNGKey(3), duration=60.0, pos_center=(0.2, 0.16, -0.46), pos_amp=0.1,
        rot_amp=0.3, base_freq=0.1, q_base=np.array([1.0, 0.0, 0.0, 0.0]))


def _tex():
    img = j_render.render_checkerboard(10, 8, 64, 32)
    return (j_recorded.BoardTexture(img, 64, 32, 0.04), t_recorded.BoardTexture(img, 64, 32, 0.04))


def test_render_frame_matches_jax():
    pose = _jax_pose()
    rows = 2.0 + 1e-4 * np.arange(SIZE[1])
    q, p = (np.array(a) for a in jax.vmap(pose)(jnp.asarray(rows)))
    jtex, ttex = _tex()
    want = np.asarray(j_recorded._render_frame_jit(
        jnp.asarray(CAM), jnp.asarray(q), jnp.asarray(p), jnp.asarray(jtex.image),
        64 / 0.04, 31.5, "division_undistortion", SIZE, 2))
    got = t_recorded._render_frame(torch.as_tensor(CAM, dtype=torch.float64), torch.as_tensor(q),
                                   torch.as_tensor(p), torch.as_tensor(ttex.image), 64 / 0.04,
                                   31.5, "division_undistortion", SIZE, 2)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    assert np.mean(want != 170.0) > 0.2  # the board is in view


def test_render_frames_matches_jax():
    pose = _jax_pose()

    def t_pose(t):
        q, p = jax.vmap(pose)(jnp.asarray(t.numpy()))
        return torch.as_tensor(np.array(q)), torch.as_tensor(np.array(p))

    jtex, ttex = _tex()
    kw = dict(time_offset=0.01, line_delay=2e-5, supersample=2, noise_std=1.5, seed=3,
              motion_blur_s=0.004, blur_taps=2, exposure_flicker=0.05)
    times = np.array([0.0, 2.5, 5.0])
    q_i_c, t_i_c = np.array([0.999, 0.02, -0.03, 0.01]), np.array([0.01, -0.02, 0.003])
    q_i_c = q_i_c / np.linalg.norm(q_i_c)
    want = j_recorded.render_frames(pose, times, "division_undistortion", CAM, q_i_c, t_i_c,
                                    jtex, SIZE, **kw)
    got = t_recorded.render_frames(t_pose, times, "division_undistortion", CAM, q_i_c, t_i_c,
                                   ttex, SIZE, device="cpu", **kw)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.uint8 and g.shape == (SIZE[1], SIZE[0])
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
