"""Port parity: the intrinsics slice (ops/pnp.py, lm.make_dense_linearizer,
core/camera_calibrator.py) and the radon path end to end through the CLIs.

Inputs are made by the JAX package from a seed and handed to both
packages as numpy; everything runs on the CPU in float64.

* pnp, initialize_views and the dense linearizer (H, g, cost): within
  1e-9 relative (float64; the difference is summation order).
* calibrate_camera on ``synthetic.make_intrinsics_scene`` observations,
  for division_undistortion, pinhole and double_sphere (the multi-start):
  parameters within 1e-6 relative, the same LM iteration counts and the
  same active views.
* The slice: frames rendered by the JAX package at 640x360 go through the
  JAX ``detect_checkerboard`` + ``calibrate_camera`` and through the
  port's ``apps/extract_board.py`` (from a PNG folder) +
  ``apps/calibrate_camera.py`` with ``--device cpu``: the same corner
  files within 1e-3 px, the calibration json within 1e-5 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.apps import calibrate_camera as t_cal_cli
from openimucameracalibrator_torch.apps import extract_board as t_ext_cli
from openimucameracalibrator_torch.core import board_extractor as t_board
from openimucameracalibrator_torch.core import camera_calibrator as t_cc
from openimucameracalibrator_torch.models import cameras as t_cameras
from openimucameracalibrator_torch.ops import pnp as t_pnp
from openimucameracalibrator_torch.solver import lm as t_lm
from openimucameracalibrator_torch.solver import robust as t_robust
from openimucameracalibrator_torch.utils import convert
from openimucameracalibrator_torch.utils import io as t_io
from openimucameracalibrator_torch.utils import synthetic as t_synthetic
from openimucameracalibrator_torch.utils import types as t_types
from openimucameracalibrator_tpu.apps import calibrate_camera as j_cal_cli
from openimucameracalibrator_tpu.core import camera_calibrator as j_cc
from openimucameracalibrator_tpu.detect import checkerboard as j_checker
from openimucameracalibrator_tpu.detect import render as j_render
from openimucameracalibrator_tpu.models import boards as j_boards
from openimucameracalibrator_tpu.models import cameras as j_cameras
from openimucameracalibrator_tpu.ops import pnp as j_pnp
from openimucameracalibrator_tpu.solver import lm as j_lm
from openimucameracalibrator_tpu.utils import io as j_io
from openimucameracalibrator_tpu.utils import recorded as j_recorded
from openimucameracalibrator_tpu.utils import synthetic as j_synthetic
from openimucameracalibrator_tpu.utils import types as j_types

TRUE_PARAMS = {
    "division_undistortion": [437.13, 489.07, 270.87, -1.4386e-06],
    "pinhole": [437.0, 437.5, 481.0, 271.5],
    "double_sphere": [364.0, 364.5, 480.0, 270.0, -0.2, 0.55],
}


@pytest.fixture(scope="module")
def scenes():
    """Corner datasets (as dicts of numpy) of the JAX intrinsics scene,
    16 views, one per model, made once."""
    out = {}
    for name, p in TRUE_PARAMS.items():
        sc = j_synthetic.make_intrinsics_scene(j_cameras.get_model(name), jnp.array(p),
                                               num_views=16, seed=3)
        out[name] = dict(times=np.asarray(sc.frame_times), points2d=np.array(sc.observations),
                         valid=np.array(sc.obs_valid), board_points=np.array(sc.board.points),
                         image_size=sc.image_size, fps=30.0)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# ops/pnp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["homography_dlt", "homography_ls", "zhang_focal",
                                "pose_from_homography", "radial_division_init"])
def test_pnp_matches_jax(fn, scenes):
    d = scenes["division_undistortion"]
    cc = np.array([480.0, 270.0])
    obs = d["points2d"] - cc
    mask = d["valid"].astype(np.float64)
    obj = np.broadcast_to(d["board_points"][:, :2], obs.shape).copy()
    T = torch.as_tensor
    if fn in ("homography_dlt", "homography_ls"):
        got = getattr(t_pnp, fn)(T(obj), T(obs), T(mask))
        want = getattr(j_pnp, fn)(jnp.asarray(obj), jnp.asarray(obs), jnp.asarray(mask))
        pairs = [(got, want)]
    elif fn == "radial_division_init":
        lam = np.linspace(-2.0, 0.5, 26) / (960.0 ** 2 + 540.0 ** 2)
        got = t_pnp.radial_division_init(T(obj), T(obs), T(mask), T(lam))
        want = j_pnp.radial_division_init(jnp.asarray(obj), jnp.asarray(obs), jnp.asarray(mask),
                                          jnp.asarray(lam))
        pairs = list(zip(got, want))
    else:
        Hs = np.array(j_pnp.homography_dlt(jnp.asarray(obj), jnp.asarray(obs),
                                           jnp.asarray(mask)))
        enough = d["valid"].sum(-1) >= 10
        if fn == "zhang_focal":
            pairs = [(t_pnp.zhang_focal(T(Hs), T(enough)),
                      j_pnp.zhang_focal(jnp.asarray(Hs), jnp.asarray(enough)))]
        else:
            f = np.full(len(Hs), 437.0)
            zero = np.zeros((len(Hs), 2))
            pairs = list(zip(t_pnp.pose_from_homography(T(Hs), T(f), T(zero)),
                             j_pnp.pose_from_homography(jnp.asarray(Hs), jnp.asarray(f),
                                                        jnp.asarray(zero))))
    for got, want in pairs:
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), want) < 1e-9, fn


# ---------------------------------------------------------------------------
# solver/lm.py: make_dense_linearizer; camera_calibrator.initialize_views
# ---------------------------------------------------------------------------

def test_initialize_views_matches_jax(scenes):
    d = scenes["division_undistortion"]
    got = t_cc.initialize_views(t_types.CornerDataset(**d), distortion_aware=True, device="cpu")
    want = j_cc.initialize_views(j_types.CornerDataset(**d), distortion_aware=True)
    assert _rel(got[0], want[0]) < 1e-9 and _rel(got[4], want[4]) < 1e-9
    assert _rel(got[1], want[1]) < 1e-9 and _rel(got[2], want[2]) < 1e-9
    np.testing.assert_array_equal(got[3], want[3])


def test_dense_linearizer_matches_jax(scenes):
    d = scenes["division_undistortion"]
    f0, q_cw, t_cw, _, lam = j_cc.initialize_views(j_types.CornerDataset(**d),
                                                   distortion_aware=True)
    V, P = d["valid"].shape
    state = {"cam": np.array([f0, 480.0, 270.0, lam]), "q_cw": np.asarray(q_cw),
             "t_cw": np.asarray(t_cw), "pts": d["board_points"]}
    view_w = np.linspace(0.5, 1.0, V)
    model_j = j_cameras.get_model("division_undistortion")
    res_j = j_cc._make_residual_fn(model_j, jnp.asarray(d["points2d"]), jnp.asarray(d["valid"]))
    lin_j, cost_j, _ = j_lm.make_dense_linearizer(
        lambda p: res_j(p, jnp.asarray(view_w)), j_cc._build_layout(V, 4, P),
        weight_fn=lambda r: j_cc.robust.huber_sqrt_weights(r, j_cc.HUBER_PX, group_size=2))
    pj = {k: jnp.asarray(v) for k, v in state.items()}
    Hj, gj, cj = (np.asarray(a) for a in jax.jit(lin_j)(pj))

    res_t = t_cc._make_residual_fn(t_cameras.get_model("division_undistortion"),
                                   torch.as_tensor(d["points2d"]), torch.as_tensor(d["valid"]))
    lin_t, cost_t, _ = t_lm.make_dense_linearizer(
        lambda p: res_t(p, torch.as_tensor(view_w)), t_cc._build_layout(V, 4, P),
        weight_fn=lambda r: t_robust.huber_sqrt_weights(r, t_cc.HUBER_PX, group_size=2))
    pt = convert.ba_params_from_numpy(state, device="cpu")
    Ht, gt, ct = lin_t(pt)
    assert Ht.shape == (4 + 6 * V + 3 * P,) * 2
    assert _rel(Ht.numpy(), Hj) < 1e-9 and _rel(gt.numpy(), gj) < 1e-9
    assert _rel(ct.item(), cj) < 1e-12
    assert _rel(cost_t(pt).item(), float(cost_j(pj))) < 1e-12
    back = convert.ba_params_to_numpy(pt)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(KeyError):
        convert.ba_params_from_numpy({"cam": state["cam"]}, device="cpu")


# ---------------------------------------------------------------------------
# core/camera_calibrator.calibrate_camera
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_name", list(TRUE_PARAMS))
def test_calibrate_camera_matches_jax(model_name, scenes):
    d = scenes[model_name]
    opts = dict(grid_size=0.01, min_num_views=5)
    cj, dj = j_cc.calibrate_camera(j_types.CornerDataset(**d), model_name,
                                   j_cc.CameraCalibratorOptions(**opts))
    ct, dt = t_cc.calibrate_camera(t_types.CornerDataset(**d), model_name,
                                   t_cc.CameraCalibratorOptions(**opts), device="cpu")
    assert dt["iters"] == dj["iters"]
    np.testing.assert_array_equal(dt["picked_views"], dj["picked_views"])
    np.testing.assert_array_equal(dt["active"], dj["active"])
    np.testing.assert_allclose(ct.params, cj.params, rtol=1e-6, atol=0)
    assert ct.mean_reproj_error == pytest.approx(cj.mean_reproj_error, rel=1e-6)
    assert _rel(dt["t_cw"], dj["t_cw"]) < 1e-6
    assert [s["iterations"] for s in dt["lm_stages"]][-3:] == dj["iters"][1:]


def test_port_intrinsics_scene_recovers_truth():
    """The port's own make_intrinsics_scene (its draws differ from the JAX
    package's): noise-free views, the calibrator recovers the camera to
    1e-6 relative."""
    sc = t_synthetic.make_intrinsics_scene(t_cameras.get_model("pinhole"),
                                           TRUE_PARAMS["pinhole"], num_views=16, noise_px=0.0,
                                           seed=3, device="cpu")
    assert sc.observations.shape == (16, 63, 2) and sc.obs_valid.sum() > 16 * 30
    ds = t_types.CornerDataset(times=sc.frame_times, points2d=sc.observations,
                               valid=sc.obs_valid, board_points=sc.board.points,
                               image_size=sc.image_size, fps=30.0)
    calib, _ = t_cc.calibrate_camera(ds, "pinhole", t_cc.CameraCalibratorOptions(
        grid_size=0.01, min_num_views=5), device="cpu")
    np.testing.assert_allclose(calib.params, TRUE_PARAMS["pinhole"], rtol=1e-6)
    assert calib.mean_reproj_error < 1e-6


# ---------------------------------------------------------------------------
# The slice: radon frames -> extract_board CLI -> calibrate_camera CLI
# ---------------------------------------------------------------------------

W, H = 640, 360
SC = W / 960.0
CAM = [437.13 * SC, 489.07 * SC, 270.87 * SC, -1.4386e-06 / (SC * SC)]  # recorded.py:215-219


def test_cli_slice_matches_jax(tmp_path):
    # The board sits closer than at 960x540 (z = -0.34 m instead of -0.46 m):
    # at 640x360 its squares are otherwise too small for the 13x13 corner
    # prototypes to find the full grid.
    pose = j_synthetic.sinusoid_trajectory(
        jax.random.PRNGKey(3), duration=60.0, pos_center=(0.2, 0.16, -0.34), pos_amp=0.08,
        rot_amp=0.3, base_freq=0.1, q_base=np.array([1.0, 0.0, 0.0, 0.0]))
    tex = j_recorded.BoardTexture(j_render.render_checkerboard(10, 8, 64, 32), 64, 32, 0.04)
    frames = j_recorded.render_frames(pose, np.linspace(0.0, 9.0, 20), "division_undistortion",
                                      CAM, np.array([1.0, 0, 0, 0]), np.zeros(3), tex, (W, H),
                                      seed=3)
    folder = tmp_path / "frames"
    folder.mkdir()
    for k, f in enumerate(frames):
        t_board.save_image(str(folder / f"{k:04d}.png"), f)

    # JAX: detect_checkerboard per frame, assembled as extract_board does.
    board = j_boards.radon_board(10, 8, 0.04)
    pts2d = np.zeros((len(frames), board.num_points, 2))
    valid = np.zeros((len(frames), board.num_points), bool)
    for v, f in enumerate(frames):
        ids, pts = j_checker.detect_checkerboard(f.astype(np.float32), 10, 8)
        pts2d[v, ids], valid[v, ids] = pts, True
    assert valid.all(-1).sum() >= 8
    j_corners = str(tmp_path / "jax.uson")
    j_io.save_corners(j_types.CornerDataset(times=np.arange(len(frames)) / 10.0,
                                            points2d=pts2d, valid=valid,
                                            board_points=board.points, image_size=(W, H),
                                            fps=10.0), j_corners)

    t_corners = str(tmp_path / "torch.uson")
    t_ext_cli.main(["--input_path", str(folder), "--save_corners_to_path", t_corners,
                    "--board_type", "radon", "--image_folder_fps", "10", "--device", "cpu"])
    a, b = t_io.load_corners(j_corners), t_io.load_corners(t_corners)
    np.testing.assert_array_equal(b.valid, a.valid)
    np.testing.assert_allclose(b.points2d[b.valid], a.points2d[a.valid], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b.times, a.times, atol=1e-6)
    assert (b.image_size, b.fps) == (a.image_size, a.fps)

    flags = ["--grid_size", "0.01", "--min_num_views", "6"]
    j_calib, t_calib = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    j_cal_cli.run(j_cal_cli.build_parser().parse_args(
        ["--input_corners", j_corners, "--save_path_calib_dataset", j_calib] + flags))
    t_cal_cli.main(["--input_corners", t_corners, "--save_path_calib_dataset", t_calib,
                    "--device", "cpu"] + flags)
    with open(j_calib) as f1, open(t_calib) as f2:
        want, got = json.load(f1), json.load(f2)
    assert got.keys() == want.keys() and got["intrinsics"].keys() == want["intrinsics"].keys()
    for k, v in list(want.items()) + list(want["intrinsics"].items()):
        if isinstance(v, float):
            g = got[k] if k in got else got["intrinsics"][k]
            assert g == pytest.approx(v, rel=1e-5, abs=1e-12), k
    assert got["nr_calib_images"] == want["nr_calib_images"] >= 6
    assert abs(got["intrinsics"]["focal_length"] - CAM[0]) < 2.0
    assert got["final_reproj_error"] < 0.2
