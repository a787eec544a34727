"""The port's CUDA kernels against their plain versions (K1, K2 and K2's
block mode, K3 against the host quad stage), and the stage-8 input stages, the static IMU calibration and
the batched camera calibration against the same functions on the CPU, on
the card.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no JAX, so it also runs where only the port is installed,
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch
from scipy import ndimage

from openimucameracalibrator_torch.core import (camera_calibrator, imu_cam_rotation,
                                                pose_estimator, static_imu_calibrator)
from openimucameracalibrator_torch.detect import (aruco_dict, charuco, image, kernels,
                                                  quad_kernels, render, video)
from openimucameracalibrator_torch.models import cameras
from openimucameracalibrator_torch.ops import lie, pnp
from openimucameracalibrator_torch.solver import gram
from openimucameracalibrator_torch.utils import synthetic
from openimucameracalibrator_torch.utils.types import CameraCalibration, CornerDataset, ImuData


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py on the GPU)")
    return torch.device("cuda")


def _problem(rng, C, rd=2, ws=9, wr=5, n_fixed=8, n_points=6, n_bias=0, sort=False):
    """Compact J (C, rd, F), r, per-measurement run indices and kernel-form
    segments laid out like the reprojection family (board points optional),
    plus a 2-block bias run when ``n_bias``. ``sort`` makes the spline runs
    time-sorted, as the linearizer's chunks are; otherwise every run index
    is uniform random, a few of them out of range."""
    order = 4
    F = 3 * order + 6 + 3 * order + n_fixed + 3 * (n_points > 0) + 6 * (n_bias > 0)
    col_r, col_f = 3 * order + 6, 3 * order + 6 + 3 * order
    J = rng.normal(size=(C, rd, F)).astype(np.float32)
    r = rng.normal(size=(C * rd,)).astype(np.float32)
    if sort:
        t = np.sort(rng.uniform(0.0, 1.0, size=C))
        runs = [np.floor(t * (w - order + 1)).astype(np.int64) for w in (ws, wr)]
    else:
        runs = [rng.integers(-1, w - order + 3, size=C) for w in (ws, wr)]
    segs = [("run", 0, order, 3, ws, 0), ("run", col_r, order, 3, wr, 3 * ws),
            ("fixed", col_f, n_fixed, 3 * ws + 3 * wr)]
    L = 3 * ws + 3 * wr + n_fixed
    col = col_f + n_fixed
    if n_points:
        runs.append(rng.integers(0, n_points, size=C))
        segs.append(("run", col, 1, 3, n_points, L))
        L, col = L + 3 * n_points, col + 3
    if n_bias:
        runs.append(np.sort(rng.integers(0, n_bias - 1, size=C)))
        segs.append(("run", col, 2, 3, n_bias, L))
        L += 3 * n_bias
    return J, r, runs, tuple(segs), L


K1_CASES = {
    # the main path's locality: time-sorted runs, obs-like widths, R = 8192
    "sorted": dict(C=4096, ws=35, wr=20, n_points=0, sort=True),
    "random": dict(C=3000),
    "ragged_rows": dict(C=1001),  # R = 2002: a 1024-row slab, then a ragged one
    "ragged_L": dict(C=512, ws=10),  # L = 71, not a multiple of 32; R = 1024: one slab
    "n_run_4": dict(C=700, n_bias=5),
    "max_f": dict(C=640, n_fixed=31),  # F = 64 = MAX_F
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_cuda_kernel_matches_plain(cuda_device, case):
    """The CUDA kernel against the plain version on the card, float32:
    relative error against max|H| within the float32 rounding of an
    R-term sum (8 sqrt(R) eps); a second launch gives the same bits."""
    J, r, runs, segs, L = _problem(np.random.default_rng(42), **K1_CASES[case])
    C, rd, F = J.shape
    n_run = len(runs)
    if case == "ragged_rows":
        assert (C * rd) % 1024 and (C * rd) % 64
    if case == "ragged_L":
        assert L % 32
    if case == "n_run_4":
        assert n_run == 4
    if case == "max_f":
        assert F == 64
    K = 2
    Jt = torch.as_tensor(np.stack([J.reshape(C * rd, F)] * K), device=cuda_device)
    rt = torch.as_tensor(np.stack([r] * K), device=cuda_device)
    idx = torch.as_tensor(np.stack([np.stack([np.repeat(i, rd) for i in runs])] * K, axis=1),
                          dtype=torch.int32, device=cuda_device).contiguous()
    before = gram.fused_gram.launches
    H, g = gram.fused_gram(Jt, rt, idx, segs, L)
    assert gram.fused_gram.launches == before + 1
    H2, g2 = gram.fused_gram(Jt, rt, idx, segs, L)
    torch.cuda.synchronize()
    assert torch.equal(H, H2) and torch.equal(g, g2)
    Hp, gp = gram.fused_gram_plain(Jt, rt, idx, segs, L)
    tol = 8 * np.sqrt(C * rd) * np.finfo(np.float32).eps
    assert (H - Hp).abs().max().item() <= tol * Hp.abs().max().item()
    assert (g - gp).abs().max().item() <= tol * gp.abs().max().item()
    with pytest.raises(ValueError):
        gram.fused_gram(Jt.double(), rt, idx, segs, L)


def _board_frame(shape, seed=7):
    board = render.render_checkerboard(10, 8, 48, 24).astype(np.float32)
    img = np.full(shape, 170.0, np.float32)
    img[40:40 + board.shape[0], 100:100 + board.shape[1]] = board
    return img + np.random.default_rng(seed).normal(0.0, 1.5, img.shape).astype(np.float32)


K2_CASES = {
    "board_960x540": dict(frame=lambda: _board_frame((540, 960))),
    "ragged_957x541": dict(frame=lambda: _board_frame((541, 957))),  # not multiples of 64x32
    "tiny_30x20": dict(frame=lambda: 255.0 * np.random.default_rng(3).random((20, 30))),
    # exact zeros: every pixel ties with its whole window, so keep is 1 everywhere
    "constant": dict(frame=lambda: np.zeros((100, 130))),
    "radius_5": dict(frame=lambda: _board_frame((540, 960)), radius=5, nms=3),  # generic
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_CASES))
def test_cuda_corner_kernel_matches_plain(cuda_device, case):
    """K2 against its plain version on the card, float32, TF32 off for
    cuDNN: resp within 2e-5 of max|resp|; keep on >= 0.999 of the pixels
    and exactly where |resp - local max| > 1e-4 of max|resp|; on the board
    frames the candidate lists hold the same points."""
    torch.backends.cudnn.allow_tf32 = False
    spec = K2_CASES[case]
    radius, nms = spec.get("radius", 6), spec.get("nms", 4)
    x = torch.as_tensor(np.asarray(spec["frame"](), np.float32), device=cuda_device)
    before = kernels.corner_response_nms.launches
    resp, keep = kernels.corner_response_nms(x, radius, nms)
    assert kernels.corner_response_nms.launches == before + 1
    resp_p, keep_p = kernels.corner_response_nms_plain(x, radius, nms)
    scale = resp_p.abs().max().item()
    assert (resp - resp_p).abs().max().item() <= 2e-5 * scale
    local_max = torch.nn.functional.max_pool2d(resp_p[None, None], 2 * nms + 1, 1, nms)[0, 0]
    agree = (keep == keep_p).float().mean().item()
    clear = (resp_p - local_max).abs() > 1e-4 * scale
    assert agree >= 0.999 and torch.equal(keep[clear], keep_p[clear])
    if case == "constant":
        assert bool((keep == 1).all()) and bool((keep_p == 1).all())
    if case in ("board_960x540", "ragged_957x541", "radius_5"):
        xy, s = image.find_corner_candidates(x, nms_radius=nms, response_radius=radius)
        xy_p, s_p = kernels.top_candidates(resp_p, keep_p, 512, 0.05)
        n = int((s_p > 0).sum())
        assert n >= 63 and int((s > 0).sum()) == n
        assert {tuple(p) for p in xy[:n].tolist()} == {tuple(p) for p in xy_p[:n].tolist()}
    for bad in (x.double(), x[None], x.t()):
        with pytest.raises(ValueError):
            kernels.corner_response_nms(bad)


K2_BLOCK_CASES = {
    # the video path's block: 32 frames at 960x540
    "block_32x540x960": dict(F=32, shape=(540, 960)),
    "ragged_3x541x957": dict(F=3, shape=(541, 957)),  # not multiples of 64x32
    "radius_5": dict(F=4, shape=(540, 960), radius=5),  # the generic instantiation
    "one_frame": dict(F=1, shape=(540, 960)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_BLOCK_CASES))
def test_cuda_corner_block_matches_plain(cuda_device, case):
    """K2's block mode (response only, one launch per block) against its
    plain version on the card, float32, TF32 off for cuDNN: within 2e-5 of
    max|resp|. A block of one frame gives the 2-D kernel's response bit for
    bit (the same FMAs in the same order); image.corner_response takes the
    block mode for (H, W) and (F, H, W) alike."""
    torch.backends.cudnn.allow_tf32 = False
    spec = K2_BLOCK_CASES[case]
    radius = spec.get("radius", 6)
    frames = np.stack([_board_frame(spec["shape"], seed=s) for s in range(spec["F"])])
    x = torch.as_tensor(frames, device=cuda_device)
    before = kernels.corner_response_block.launches
    resp = kernels.corner_response_block(x, radius)
    assert kernels.corner_response_block.launches == before + 1
    resp_p = kernels.corner_response_block_plain(x, radius)
    torch.cuda.synchronize()
    assert resp.shape == x.shape
    scale = resp_p.abs().max().item()
    assert (resp - resp_p).abs().max().item() <= 2e-5 * scale
    if case == "one_frame":
        nms_before = kernels.corner_response_nms.launches
        assert torch.equal(resp[0], kernels.corner_response_nms(x[0], radius)[0])
        assert torch.equal(image.corner_response(x[0], radius), resp[0])
        assert kernels.corner_response_nms.launches == nms_before + 1
    assert torch.equal(image.corner_response(x, radius), resp)
    assert kernels.corner_response_block.launches == before + 2 + (case == "one_frame")
    for bad in (x.double(), x[0], x.transpose(1, 2)):
        with pytest.raises(ValueError):
            kernels.corner_response_block(bad)


@pytest.mark.cuda
def test_pose_and_rotation_init_on_the_card_match_the_cpu(cuda_device):
    """estimate_poses and estimate_imu_to_camera_rotation in float32 on the
    card against float64 on the CPU, on a 10 s scene: the same valid views,
    poses within 1e-4 (m and rad: float32 of a GN minimum, each side with
    its own random stream), the time offset within the search tolerance
    1e-4 s, rotation and gyro bias within 1e-4."""
    cam = [437.0, 437.5, 481.0, 271.5]
    sc = synthetic.make_imu_camera_scene(cameras.get_model("pinhole"), cam, duration=10.0,
                                         cam_fps=10.0, imu_rate=100.0, time_offset=-0.0813,
                                         noise_px=0.15, seed=4, device="cpu")
    ds = CornerDataset(sc.frame_times, sc.observations, sc.obs_valid,
                       np.asarray(sc.board.points), sc.image_size, 10.0)
    calib = CameraCalibration("pinhole", np.asarray(cam), sc.image_size, 0.0)
    p_cpu = pose_estimator.estimate_poses(ds, calib, device="cpu")
    p_gpu = pose_estimator.estimate_poses(ds, calib, device=cuda_device)
    np.testing.assert_array_equal(p_gpu.valid, p_cpu.valid)
    v = p_cpu.valid
    assert v.mean() > 0.8
    r_err = torch.linalg.vector_norm(lie.quat_boxminus(
        torch.as_tensor(p_gpu.q_w_c[v]), torch.as_tensor(p_cpu.q_w_c[v])), dim=-1)
    assert float(r_err.max()) < 1e-4
    np.testing.assert_allclose(p_gpu.t_w_c[v], p_cpu.t_w_c[v], rtol=0, atol=1e-4)

    imu = ImuData(sc.imu_times, sc.accel, sc.gyro)
    i_cpu = imu_cam_rotation.estimate_imu_to_camera_rotation(p_cpu, imu, device="cpu")
    i_gpu = imu_cam_rotation.estimate_imu_to_camera_rotation(p_cpu, imu, device=cuda_device)
    assert abs(i_gpu.time_offset - i_cpu.time_offset) < 1e-4
    q_err = torch.linalg.vector_norm(lie.quat_boxminus(
        torch.as_tensor(i_gpu.q_gyro_to_cam), torch.as_tensor(i_cpu.q_gyro_to_cam)))
    assert float(q_err) < 1e-4
    np.testing.assert_allclose(i_gpu.gyro_bias, i_cpu.gyro_bias, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_static_imu_calibration_on_the_card_matches_the_cpu(cuda_device):
    """static_imu_calibrator.calibrate in float32 on the card against
    float64 on the CPU, on tests/test_static_imu.py's multi-pose data: the
    same static intervals; accelerometer parameters within 2e-5 (float32
    of a fit to static means of ~10 m/s^2: ~1e-7 relative per residual);
    gyroscope parameters within 5e-4 (the RK4 product of ~220 float32
    steps per segment carries ~1e-5 into residuals of ~1e-4)."""
    imu = synthetic.make_multipose_imu(np.random.default_rng(42))
    opts = static_imu_calibrator.StaticImuCalibratorOptions(
        init_static_duration_s=5.0, min_intervals=12, min_interval_samples=150)
    a_cpu, g_cpu, i_cpu = static_imu_calibrator.calibrate(imu, opts, device="cpu")
    a_gpu, g_gpu, i_gpu = static_imu_calibrator.calibrate(imu, opts, device=cuda_device)
    assert (i_gpu["num_intervals"], i_gpu["threshold_mult"]) == (
        i_cpu["num_intervals"], i_cpu["threshold_mult"])
    for k in ("misalignment", "scale", "bias"):
        np.testing.assert_allclose(getattr(a_gpu, k), getattr(a_cpu, k), rtol=0, atol=2e-5)
        np.testing.assert_allclose(getattr(g_gpu, k), getattr(g_cpu, k), rtol=0, atol=5e-4)


@pytest.mark.cuda
def test_camera_batch_on_the_card_matches_the_cpu(cuda_device):
    """calibrate_camera_batch in float32 on the card against float64 on the
    CPU: three models (double sphere with its multi-start lanes), 16 views
    each of the port's intrinsics scene. The same picked views; camera
    parameters within 1e-4 relative and mean reprojection errors within
    1e-3 relative (a float32 BA minimum). For the double sphere, whose
    (f, xi) has near-equivalent mirror families over a finite field of
    view (the float32 and float64 multi-starts may keep lanes of different
    families at near-equal cost), the family-invariant near-axis
    magnification f / (1 + xi) and the principal point, as
    tests/test_camera_calibrator.py holds it."""
    true = {"pinhole": [437.0, 437.5, 481.0, 271.5],
            "division_undistortion": [437.13, 489.07, 270.87, -1.4386e-06],
            "double_sphere": [364.0, 364.5, 480.0, 270.0, -0.2, 0.55]}
    jobs = []
    for i, (name, p) in enumerate(true.items()):
        sc = synthetic.make_intrinsics_scene(cameras.get_model(name), p, num_views=16,
                                             seed=3 + i, device="cpu")
        jobs.append((name, CornerDataset(sc.frame_times, sc.observations, sc.obs_valid,
                                         np.asarray(sc.board.points), sc.image_size, 30.0)))
    opts = camera_calibrator.CameraCalibratorOptions(grid_size=0.01, min_num_views=5)
    got = camera_calibrator.calibrate_camera_batch(jobs, opts, device=cuda_device)
    want = camera_calibrator.calibrate_camera_batch(jobs, opts, device="cpu")
    for (cg, dg), (cw, dw) in zip(got, want, strict=True):
        assert cg.model_name == cw.model_name
        np.testing.assert_array_equal(dg["picked_views"], dw["picked_views"])
        if cg.model_name == "double_sphere":
            mag_g, mag_w = cg.params[0] / (1 + cg.params[4]), cw.params[0] / (1 + cw.params[4])
            assert mag_g == pytest.approx(mag_w, rel=1e-4)
            np.testing.assert_allclose(cg.params[2:4], cw.params[2:4], rtol=1e-4, atol=0)
        else:
            np.testing.assert_allclose(cg.params, cw.params, rtol=1e-4, atol=0)
        assert cg.mean_reproj_error == pytest.approx(cw.mean_reproj_error, rel=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("run_seed", [102, 103])
def test_double_sphere_rig_on_the_card_recovers_the_truth(cuda_device, run_seed, tmp_path):
    """Stage 1 of the gopro6_ds5 rig as its benchmark cell makes it: the
    300 intrinsics views of the cell's first recording for run seeds 102
    and 103 (read back from the corner file), the CLI's 0.04 m voxel grid,
    float32 on the card. Unguarded, the multi-start kept an all-invalid
    start on both (f_x 18,408.7 and -46,313.8 at 0 px). The bars of
    tests/test_torch_double_sphere.py and their reasons: f / (1 + xi)
    within 3 % (seed 102 reads 444.3 against 436.2, +1.85 %), the
    principal point within 2.5 px, over 95 % of the kept views'
    observations validly projected, a mean error above 0."""
    import json
    import os

    from benchmarks.entries import calibrate as bench_calibrate
    from benchmarks.gen import files, scene
    from openimucameracalibrator_torch.utils import io

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmarks", "configs", "gopro6_ds5.json")) as f:
        cfg = json.load(f)
    truth = np.asarray(cfg["cam_params"], np.float64)
    noise_seed = bench_calibrate.noise_seeds(run_seed, 2)[0]
    sc = scene.make_intrinsics_scene("double_sphere", truth, num_views=300,
                                     image_size=tuple(cfg["image_size"]), noise_px=0.2,
                                     seed=11 + 1000, noise_seed=noise_seed + 1, device="cpu")
    path = str(tmp_path / "cam_corners.uson")
    files.write_corners(path, sc.frame_times, sc.observations, sc.obs_valid, sc.board_points,
                        sc.image_size, cfg["cam_fps"])
    ds = io.load_corners(path)
    calib, det = camera_calibrator.calibrate_camera(
        ds, "DOUBLE_SPHERE", camera_calibrator.CameraCalibratorOptions(grid_size=0.04),
        device=cuda_device)
    p = np.asarray(calib.params, np.float64)
    mag, mag_true = p[0] / (1 + p[4]), truth[0] / (1 + truth[4])
    assert abs(mag - mag_true) / mag_true < 0.03
    np.testing.assert_allclose(p[2:4], truth[2:4], rtol=0, atol=2.5)
    assert calib.mean_reproj_error > 0.1
    valid = np.asarray(ds.valid)[det["picked_views"]]
    q, t = torch.as_tensor(det["q_cw"]), torch.as_tensor(det["t_cw"])
    p_cam = lie.quat_rotate(q[:, None, :], torch.as_tensor(det["board_points"])[None]) \
        + t[:, None, :]
    _, ok = cameras.get_model("double_sphere").project(torch.as_tensor(p), p_cam)
    assert (ok.numpy() & valid).sum() > 0.95 * valid.sum()


def _card_sequences(device, durations=(3.0, 4.5), seeds=(3, 4)):
    """Pinhole recordings of tests/test_batch_estimator.py's settings on the
    card: [(problem, params0)] in float32."""
    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.utils.types import PoseDataset, SplineWeightingData

    cam = [437.0, 437.5, 481.0, 271.5]
    out = []
    for duration, seed in zip(durations, seeds):
        sc = synthetic.make_imu_camera_scene(cameras.get_model("pinhole"), cam,
                                             duration=duration, cam_fps=20.0, imu_rate=100.0,
                                             noise_px=0.15, seed=seed, device=device)
        ds = CornerDataset(sc.frame_times, sc.observations, sc.obs_valid, sc.board.points,
                           sc.image_size, 20.0)
        imu = ImuData(sc.imu_times, sc.accel, sc.gyro)
        p = se.build_problem(ds, CameraCalibration("pinhole", np.asarray(cam), sc.image_size,
                                                   0.0), imu,
                             SplineWeightingData(dt_so3=0.1, dt_r3=0.1, std_so3=0.002,
                                                 std_r3=0.02, cam_fps=20.0),
                             -0.05, rolling_shutter=False, device=device)
        poses = PoseDataset(sc.frame_times, sc.q_w_c, sc.t_w_c,
                            np.ones(len(sc.frame_times), bool), sc.board.points)
        out.append((p, se.init_spline_params(poses, np.asarray(sc.q_i_c) + 0.005,
                                             np.asarray(sc.t_i_c) + 0.004, p, imu,
                                             pose_time_offset=-0.05, device=device)))
    return out


@pytest.mark.cuda
def test_cuda_batched_linearizer_folds_sequences(cuda_device):
    """One batched linearization of N=2 sequences makes one K1 launch per
    family over the N*K folded chunks; each sequence's chunks of that
    launch equal the plain version on the same inputs (8 sqrt(R) eps of
    the sequence's largest entry), and each sequence's (H, g) equal its
    own single-sequence linearization (1e-5 of the largest entry)."""
    from openimucameracalibrator_torch.core import batch_estimator as be
    from openimucameracalibrator_torch.core import spline_estimator as se

    seqs = _card_sequences(cuda_device)
    batch = be.build_sequence_batch([p for p, _ in seqs], obs_chunk=512, imu_chunk=128)
    layout = se.build_layout(batch.p_ref)
    params_b = be.stack_params(batch, [prm for _, prm in seqs])
    calls, real = [], gram.fused_gram

    def spy(J, r, idx, segs, L, tag=None):
        gram.fused_gram = real
        try:
            H, g = real(J, r, idx, segs, L, tag=tag)
        finally:
            gram.fused_gram = spy
        calls.append((tag, J, r, idx, segs, L, H, g))
        return H, g

    gram.fused_gram = spy
    try:
        H_b, g_b, _ = be.make_batch_linearizer(batch, layout)(params_b)
    finally:
        gram.fused_gram = real
    k_of = {"obs": batch.plans[0].n_chunks, "accel": batch.plans[1].n_chunks,
            "gyro": batch.plans[2].n_chunks}
    assert sorted(c[0] for c in calls) == ["accel", "gyro", "obs"]
    for tag, J, r, idx, segs, L, H, g in calls:
        K = k_of[tag]
        assert J.shape[0] == batch.n_seq * K
        tol = 8 * np.sqrt(J.shape[1]) * np.finfo(np.float32).eps
        for n in range(batch.n_seq):
            sl = slice(n * K, (n + 1) * K)
            Hp, gp = gram.fused_gram_plain(J[sl], r[sl], idx[:, sl].contiguous(), segs, L)
            assert (H[sl] - Hp).abs().max().item() <= tol * Hp.abs().max().item()
            assert (g[sl] - gp).abs().max().item() <= tol * gp.abs().max().item()
    for n, (p, prm) in enumerate(seqs):
        H, g, _ = se.make_solver_functions_fast(p, se.build_layout(p), obs_chunk=512,
                                                imu_chunk=128)[0](prm)
        own = torch.as_tensor(batch.pad_masks[n] > 0, device=cuda_device)
        Hn, gn = H_b[n][own][:, own], g_b[n][own]
        assert (Hn - H).abs().max().item() <= 1e-5 * H.abs().max().item()
        assert (gn - g).abs().max().item() <= 1e-5 * g.abs().max().item()


@pytest.mark.cuda
def test_cuda_sharded_matches_single_device(cuda_device):
    """4 shards in one process on the card: the summed (H, g, cost) equal the
    single-device linearizer's (1e-5 of the largest entry), with one K1
    launch per family and shard."""
    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.parallel import sharded

    (p, prm), = _card_sequences(cuda_device, durations=(6.0,), seeds=(5,))
    layout = se.build_layout(p)
    H0, g0, c0 = se.make_solver_functions_fast(p, layout)[0](prm)
    lin, cost, _ = sharded.make_sharded_fast_solver_functions(
        p, sharded.make_mesh(4, device=cuda_device), obs_chunk=1024, imu_chunk=256)
    gram.reset_counts()
    H1, g1, c1 = lin(prm)
    torch.cuda.synchronize()
    assert gram.fused_gram.launches_by_tag == {"obs": 4, "accel": 4, "gyro": 4}
    assert (H1 - H0).abs().max().item() <= 1e-5 * H0.abs().max().item()
    assert (g1 - g0).abs().max().item() <= 1e-5 * g0.abs().max().item()
    assert float(c1) == pytest.approx(float(c0), rel=1e-5)
    assert float(cost(prm)) == pytest.approx(float(c0), rel=1e-5)


# ---------------------------------------------------------------------------
# K3: the quad stage of the batched charuco path
# ---------------------------------------------------------------------------

_DICT = aruco_dict.aruco_original_dictionary(64)
_SPEC = charuco.CharucoBoardSpec(10, 8, 0.04, 0.03, _DICT)


@functools.lru_cache(maxsize=None)
def _charuco_views(n, seed=3):
    """n warped renders (540x660) of the 10x8 charuco board, as the CPU
    charuco tests make them, with 1.5 DN noise: uint8 (n, 540, 660)."""
    img = render.render_charuco_board(_DICT, 10, 8, 0.04, 0.03, px_per_square=60, margin_px=30)
    h0, w0 = img.shape
    rng = np.random.default_rng(seed)
    src = np.float64([[0, 0], [w0, 0], [w0, h0], [0, h0]])
    out = []
    for _ in range(n):
        dst = (np.float64([[50, 40], [w0 - 60, 45], [w0 - 40, h0 - 50], [55, h0 - 35]])
               + rng.uniform(-40, 40, (4, 2)))
        f64 = dict(dtype=torch.float64)
        H = pnp.homography_dlt(torch.as_tensor(src[None], **f64),
                               torch.as_tensor(dst[None], **f64),
                               torch.ones((1, 4), **f64))[0].numpy()
        view = render.warp_image(img, H / H[2, 2], (h0, w0)) + rng.normal(0.0, 1.5, (h0, w0))
        out.append(np.clip(np.rint(view), 0, 255).astype(np.uint8))
    return np.stack(out)


def _blobs(F, h, w, seed, sigma=4.0, level=0.6):
    """Thresholded smoothed noise: irregular components with holes, forks
    and U-shapes that join late, some touching the borders."""
    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.normal(size=(F, h, w)), (0, sigma, sigma))
    return field > level * field.std()


def _borders():
    """Components touching every border: a ring round the frame, blocks in
    the four corners, a band from the left to the right border, and a
    frame of blobs."""
    m = np.zeros((3, 100, 130), bool)
    m[0, :3], m[0, -3:], m[0, :, :3], m[0, :, -3:] = True, True, True, True
    m[0, 30:60, 40:75] = True
    m[1, :20, :25], m[1, :18, -30:], m[1, -22:, :27], m[1, -15:, -33:] = True, True, True, True
    m[1, 45:55, :] = True
    m[1, 60:75, 33:97] = True  # across the 32- and 64-pixel warp segment edges
    m[2] = _blobs(1, 100, 130, seed=5, sigma=6.0, level=0.3)[0]
    return m


def _polygons(F, h, w, seed, n=30):
    """Filled convex quadrilaterals at random sizes and angles (pixel
    centres inside all four edges)."""
    rng = np.random.default_rng(seed)
    m = np.zeros((F, h, w), bool)
    ys, xs = np.mgrid[0:h, 0:w]
    for f in range(F):
        for _ in range(n):
            c = rng.uniform([15, 15], [w - 15, h - 15])
            r = rng.uniform(5, 25)
            a = np.sort(rng.uniform(0, 2 * np.pi, 4))
            v = c + r * np.stack([np.cos(a), np.sin(a)], -1)
            inside = np.ones((h, w), bool)
            for k in range(4):
                p, q = v[k], v[(k + 1) % 4]
                inside &= (q[0] - p[0]) * (ys - p[1]) - (q[1] - p[1]) * (xs - p[0]) >= 0
            m[f] |= inside
    return m


def _tall():
    """A diamond 151 rows high and a slanted bar 200 rows high: more rows
    than P/2 = 64, so the quad fit takes every stride-th row."""
    m = np.zeros((2, 300, 300), bool)
    ys, xs = np.mgrid[0:300, 0:300]
    m[0] = np.abs(xs - 150) + np.abs(ys - 150) <= 75
    m[1] = (ys >= 50) & (ys < 250) & (xs >= 60 + ys // 2) & (xs < 120 + ys // 2)
    return m


def _squares(F, h, w, seed, sizes, pitch):
    """A grid of squares with sides drawn from ``sizes``: many components of
    equal area, more than Q of them."""
    rng = np.random.default_rng(seed)
    m = np.zeros((F, h, w), bool)
    for f in range(F):
        for y in range(2, h - pitch, pitch):
            for x in range(2, w - pitch, pitch):
                k = int(rng.choice(sizes))
                m[f, y:y + k, x:x + k] = True
    return m


K3_CASES = {
    # rendered charuco views: the masks of the pixel stage on the card
    "rendered": dict(views=3),
    "rendered_down2": dict(views=3, down=2),
    "empty": dict(mask=lambda: np.zeros((2, 64, 96), bool)),
    "borders": dict(mask=_borders),
    "blobs": dict(mask=lambda: _blobs(4, 120, 200, seed=1)),
    # full size, and more than Q = 128 components in the area limits
    "blobs_960x540": dict(mask=lambda: _blobs(2, 540, 960, seed=2, sigma=5.0, level=0.4),
                          truncated=True),
    "polygons": dict(mask=lambda: _polygons(3, 240, 320, seed=4)),
    "tall": dict(mask=_tall),
    # more than Q = 128 kept components, areas 81, 100 and 121: ties at the cut
    "crowded": dict(mask=lambda: _squares(2, 200, 300, seed=6, sizes=(9, 10, 11), pitch=14),
                    truncated=True),
    # every area equal, Q = 16: the cut falls inside one tie
    "tied": dict(mask=lambda: _squares(1, 120, 160, seed=7, sizes=(10,), pitch=16),
                 max_quads=16, truncated=True),
}


def _kept(mask, down, marker):
    """Components per frame inside find_quad_candidates' area limits."""
    out = []
    for m in mask:
        labels, n = ndimage.label(m)
        areas = np.bincount(labels.ravel(), minlength=n + 1)[1:]
        out.append(int(((areas >= marker.min_area_px / (down * down))
                        & (areas <= marker.max_area_frac * m.size)).sum()))
    return np.array(out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K3_CASES))
def test_cuda_quad_kernel_matches_host(cuda_device, case):
    """K3 against the host quad stage (video._host_quads: scipy labelling
    and quads.find_quad_candidates) on the same masks, frame by frame: the
    same quads and qvalid, exactly (every coordinate is an integer pixel
    index); n_kept equals the host's count of components inside the area
    limits."""
    spec = K3_CASES[case]
    down = spec.get("down", 1)
    opts = video.VideoDetectorOptions(label_downsample=down,
                                      max_quads=spec.get("max_quads", 128))
    if "views" in spec:
        stack = torch.as_tensor(_charuco_views(spec["views"]), device=cuda_device)
        _, maskd, _ = video._stage_pixels(stack, opts.marker.threshold_radius,
                                          opts.marker.threshold_c, down, 6, False, pack=False)
    else:
        maskd = torch.as_tensor(spec["mask"](), device=cuda_device)
    mask_np = maskd.cpu().numpy()
    before = quad_kernels.quad_candidates_block.launches, quad_kernels.quad_candidates_block.frames
    quads_b, qvalid, n_kept = quad_kernels.quad_candidates_block(maskd, down, opts.max_quads,
                                                                 opts.marker)
    torch.cuda.synchronize()
    assert (quad_kernels.quad_candidates_block.launches,
            quad_kernels.quad_candidates_block.frames) == (before[0] + 1,
                                                           before[1] + mask_np.shape[0])
    want_q, want_v = video._host_quads(mask_np, opts)
    np.testing.assert_array_equal(qvalid.cpu().numpy(), want_v)
    np.testing.assert_array_equal(quads_b.cpu().numpy(), want_q)
    kept = _kept(mask_np, down, opts.marker)
    np.testing.assert_array_equal(n_kept.cpu().numpy(), kept)
    if case in ("rendered", "rendered_down2", "polygons", "tall"):
        assert want_v.sum(1).min() >= (30 if case.startswith("rendered") else 1)
    assert (kept > opts.max_quads).any() == spec.get("truncated", False)
    if case == "empty":
        assert not want_v.any()
    for bad in (maskd.to(torch.uint8), maskd[0], maskd.transpose(1, 2)):
        with pytest.raises(ValueError):
            quad_kernels.quad_candidates_block(bad, down, opts.max_quads, opts.marker)


@pytest.mark.cuda
def test_cuda_detection_block_makes_no_host_sync(cuda_device):
    """One block from board.pixels through K3 to board.decode under
    torch.cuda.set_sync_debug_mode("error"): nothing in the chain waits on
    the device (a first block, outside the check, builds the kernels and
    the device constants)."""
    opts = video.VideoDetectorOptions(batch_frames=4)
    board = video._Board(_SPEC, opts, cuda_device)
    stack = torch.as_tensor(_charuco_views(4), device=cuda_device)

    def block():
        gray, maskd, resp = board.pixels(stack, False)
        quads_b, qvalid, n_kept = board.quads(maskd)
        return board.decode(gray, resp, quads_b, qvalid) + (n_kept,)

    want = block()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = block()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    (refined, ok, n_markers, n_kept), (refined_w, ok_w, n_markers_w, n_kept_w) = got, want
    assert torch.equal(n_kept, n_kept_w) and torch.equal(n_markers, n_markers_w)
    assert torch.equal(ok, ok_w) and int(ok.sum(1).min()) >= 55
    assert (refined - refined_w)[ok].abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_graphed_blocks_match_eager(cuda_device):
    """video._CardBlocks (K3 and the decode stage: eager at a shape's first
    block, captured as a CUDA graph at its second, replayed from then on)
    against the eager stages on three blocks of different views: the same
    quad counts and corner flags, corners within 1e-3 px as between two
    eager runs (the sync test above); K3's counters count each replay as a
    launch and the capture as none."""
    opts = video.VideoDetectorOptions(batch_frames=2)
    board = video._Board(_SPEC, opts, cuda_device)
    views = torch.as_tensor(_charuco_views(6), device=cuda_device)
    blocks = [board.pixels(views[k:k + 2], False) for k in (0, 2, 4)]
    card = video._CardBlocks(board)
    quad_kernels.reset_counts()
    # the captured block's tensors become the graph's inputs: hand it copies
    got = [[t.clone() for t in card(*[x.clone() for x in b])] for b in blocks]
    torch.cuda.synchronize()
    assert (quad_kernels.quad_candidates_block.launches,
            quad_kernels.quad_candidates_block.frames) == (3, 6)
    assert card.graphs[(2,) + tuple(views.shape[1:])] is not None
    for (refined, ok, n_kept), b in zip(got, blocks):
        refined_w, ok_w, n_kept_w = card.stages(*b)
        assert torch.equal(n_kept, n_kept_w) and torch.equal(ok, ok_w)
        assert int(ok.sum(1).min()) >= 55
        assert (refined - refined_w)[ok].abs().max().item() <= 1e-3
    assert not torch.equal(got[0][0], got[2][0])


@pytest.mark.cuda
def test_cuda_video_detection_matches_the_cpu(cuda_device, monkeypatch):
    """detect_charuco_video on the card (K2's block mode, K3, the decode
    stage) against the CPU route (plain response, host quads) on five
    views in blocks of 2 (a padded tail block): the same ids in every
    frame, corners within 1e-3 px (the masks agree bit for bit, since the
    threshold's window sums are sums of integers; the response and the
    subpixel refinement are float32 sums in other orders, as in the CPU
    tests against the JAX package). K3 runs once per block and the host
    quad stage never on the card."""
    frames = [(0.1 * k, g) for k, g in enumerate(_charuco_views(5))]
    opts = video.VideoDetectorOptions(batch_frames=2)
    want = list(video.detect_charuco_video(iter(frames), _SPEC, opts, device="cpu"))

    def host_quads(*a, **kw):
        raise AssertionError("the host quad stage ran on the card")

    monkeypatch.setattr(video, "_host_quads", host_quads)
    quad_kernels.reset_counts()
    got = list(video.detect_charuco_video(iter(frames), _SPEC, opts, device=cuda_device))
    assert (quad_kernels.quad_candidates_block.launches,
            quad_kernels.quad_candidates_block.frames,
            quad_kernels.quad_candidates_block.truncated_frames) == (3, 6, 0)
    assert len(got) == len(want) == len(frames)
    for (t, ids, pts), (t_w, ids_w, pts_w) in zip(got, want):
        assert t == t_w
        np.testing.assert_array_equal(ids, ids_w)
        np.testing.assert_allclose(pts, pts_w, rtol=0, atol=1e-3)
        assert len(ids) >= 55
