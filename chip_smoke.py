#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases (every failure exits non-zero; nothing is caught and carried on):

1. device    — the card's name, and its name and power limit per nvidia-smi.
2. build     — build the three CUDA kernels at once, one nvcc each: the
               fused densify + Gram (csrc/gram.cu, K1), the corner response
               + NMS with its block mode (csrc/corner_nms.cu, K2) and the
               quad stage (csrc/quad_labels.cu, K3); beside them the host
               GPMF reader (csrc/gpmf_reader.cc, g++).
3. scene     — the DS3-scale synthetic recording (60 s, 60 fps, 200 Hz IMU,
               960x540 division-undistortion camera, rolling shutter,
               charuco 10x8) rendered on the card, and its stage-8 input
               artifacts written to a temporary directory.
4. K1        — the Gram kernel against its plain PyTorch version for the
               three families of that recording's chunk plan, on uniformly
               random block indices and on the linearizer's own inputs at
               the initial point (the main path's time-sorted indices,
               caught by a spy on gram.fused_gram); two launches must give
               the same bits; with times.
5. stage 8   — the port's stage-8 CLI on those artifacts on the card, with
               its default iteration caps; recovery of the truth, and the
               K1 launches counted during the run; then the time of one
               linearization of the same problem.
5b. banded   — the same recording cut to 300 s (D = 28,358, above
               BANDED_MIN_DIM): at the initial point the banded damped step
               against the dense one and a float64 dense one; then the
               stage-8 CLI on it, which must take the banded solve for
               every LM iteration (a spy counts the solves), with the same
               bars and K1's launches.
6. render    — 300 frames at 960x540 of a 10x8 checkerboard (0.04 m
               squares) through the division-undistortion camera along a
               sinusoid trajectory, rendered on the card (supersample 2,
               1.5 DN noise).
7. K2        — the corner kernel against its plain PyTorch version on one of
               those frames and on one random frame: response, local-max
               mask, candidate lists; on that frame at radius 5 (the generic
               instantiation) too; with times.
8. intrinsics — the radon path on the card: extract_board on the 300 frames,
               the corner file, the calibrate_camera CLI; recovery of the
               camera, and one K2 launch per frame.
8b. charuco  — the same 300 frames of the 10x8 charuco board (0.03 m
               markers, DICT_ARUCO_ORIGINAL): extract_board on the batched
               video path (32 frames per block), corners against the
               render's truth, one K2 block-mode launch per block, the
               per-stage detection times (video.benchmark_block, the mask
               fetched packed and unpacked), K2's block mode against its
               plain version on one block (and at radius 5), with times;
               then the calibrate_camera CLI with phase 8's bars. One K3
               launch per block, its counters printed.
8c. K3       — the quad stage on the card (csrc/quad_labels.cu) against the
               host route (video._host_quads) on one 32-frame block of
               those frames: the same quads and validity, exactly; K3's
               time beside its bound and the host route's (mask fetch and
               unpack, labelling and fit); its counters.
9. pipeline  — the run_calibration CLI on the card on its default board
               (charuco), from a workspace seeded with phase 8b's corners
               (intrinsics) and the DS3 scene's corners (imu-cam) and its
               telemetry: stages 1, 4, 5, 6, 7 and 8; recovery of the truth, SEW inside its search
               ranges, three K1 launches per linearization, K1's first
               launch of each family held against its plain version at the
               shapes this run gives it (its own SEW changes them, so they
               are not phase 4's), K2 launches counted. Then stages 5
               (pose estimation) and 7 (rotation / time-offset init) alone on
               the same inputs, timed, and on the DS3 scene rendered with a
               global shutter, where they are held to the JAX tests' bars
               (both stages model a global shutter).
10. gopro    — the user's path from a GoPro-style MP4: recorded.make_recording
               at bench.py's DS3 scale (60 s at 60 fps, 960x540
               division-undistortion camera, rolling shutter, 200 Hz IMU,
               10x8 charuco, seed 5) renders on the card and writes cam.MP4
               and imu_cam.MP4 (MJPEG + GPMF track); a spy keeps the
               rendered frames. extract_board (charuco, K2 block mode, 32
               frames per block) detects them on the card, stamped with the
               times that decoding the MP4 gives (checked against a cv2
               decode where cv2 is installed), into a workspace; then the
               run_calibration CLI with --telemetry_format gopro reads the
               telemetry from the GPMF track (the g++-built reader) and runs
               stages 1-9 on the card. Held to tests/test_recorded_e2e.py's
               bars and the stage-8 line-delay bar; K2 block launches counted
               during detection, K1 launches during the CLI (each family's
               first launch held against its plain version).
11. static IMU — the static-imu-calibration tool on the card on the
               multi-pose recording of tests/test_static_imu.py (the port's
               synthetic.make_multipose_imu), read back with
               io.load_imu_intrinsics and held to that test's bars; the gyro
               LM's time, and its CUDA launches counted by torch.profiler.
12. batch    — core/batch_estimator.optimize_batch on four DS3-scale sequences
               (bench.py's measure_batch: 60 / 54 / 57 / 60 s, seeds 7-10,
               float32, obs / imu chunks 4096 / 256), started ~17 mrad, 10 mm,
               3 ms and one frame time per 540 rows off: independent mode
               (each sequence held to phase 5's bars, sequence 0 against its
               own single solve) and joint mode (the shared blocks identical,
               every sequence held to the same bars); exactly 3 K1 launches
               per batched linearization, each family's first held against
               its plain version; one batched linearization timed against the
               four single ones, with its peak memory, and its sequential
               (one chunk at a time) mode; K1 timed at the batched shapes.
13. sharded  — parallel/sharded.py and parallel/schur.py over 4 shards of the
               card on the 60 s problem: the summed normal equations against
               the single-device linearizer, 3 LM iterations of each solver
               against the single-device solve, K1 launches per shard; then
               the process-group layout: the sharded solve at world size 1 on
               NCCL, and on 2 ranks of the card over gloo in subprocesses
               (each loads only its time slice; 600 s limit, killed on expiry).
14. batch CLI — apps/batch_calibration --mode joint on two short
               make_recording captures (tests/test_batch_cli.py's settings)
               rendered on the card, their frames fed to the detectors as in
               phase 10, intrinsics from the first capture's intrinsics video;
               held to that test's bars, K2 and K1 launches counted.

The line before the last is a JSON object listing every ported kernel; the
last line is ``{"ok": true, "device": {...}}``. Needs one CUDA device and
the ``openimucameracalibrator_torch`` package beside this script; imports
nothing of the JAX package.
"""

import concurrent.futures
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

DURATION = 60.0
CAM_FPS = 60.0
IMU_RATE = 200.0
LINE_DELAY = 30.895e-6
TIME_OFFSET = -0.0813
CAM = [437.13, 489.07, 270.87, -1.4386e-06]
SEW = dict(dt_so3=0.050, dt_r3=0.089, std_so3=0.002, std_r3=0.02)
INIT_ROT_ERR, INIT_TIME_ERR = 3e-3, 3e-3  # rotation-init perturbation: rad, s

# Intrinsics path: the 10x8 checkerboard, 0.04 m squares, seen by the
# division-undistortion camera CAM with identity extrinsics.
N_FRAMES = 300
SQUARES = (10, 8)
TRAJ = dict(pos_center=(0.2, 0.16, -0.46), pos_amp=0.1, rot_amp=0.3, base_freq=0.1,
            q_base=[1.0, 0.0, 0.0, 0.0])

# Charuco intrinsics path: the run_calibration default board, 10x8 charuco,
# DICT_ARUCO_ORIGINAL, along the same trajectory.
CHARUCO = dict(square_length=0.04, marker_length=0.03)

# Banded path: the DS3 recording cut to 300 s (D ~ 28.4k, the size at which
# the port used to raise), its damped solve at this lambda.
BANDED_DURATION = 300.0
BANDED_LAM = 1e-4

# GoPro path: bench.py's _e2e_dataset (bench.py:682-688), and the JAX
# package's TPU v5e accuracy record of it (bench_cache/e2e_tpu.json; corners
# from decoded JPEG frames there, from the unencoded frames here).
GOPRO = dict(model_name="division_undistortion", image_size=(960, 540), duration=60.0,
             cam_fps=60.0, intrinsics_frames=30, imu_rate=IMU_RATE, time_offset=TIME_OFFSET,
             line_delay=LINE_DELAY, squares_x=10, squares_y=8, square_length=0.04,
             marker_length=0.03, seed=5)
GOPRO_TPU = dict(intrinsics_reproj_px=0.2993, final_reproj_px=0.4731, time_offset_err_ms=0.29,
                 line_delay_err_us=0.444)
CAM_VIDEO_FPS = 2.0  # make_recording's intrinsics video rate

# Batch path: bench.py's measure_batch configuration (bench.py:415-470), four
# DS3-scale sequences of these lengths and scene seeds, float32.
BATCH_DURATIONS = (60.0, 54.0, 57.0, 60.0)
BATCH_SEEDS = (7, 8, 9, 10)
BATCH_CHUNKS = dict(obs_chunk=4096, imu_chunk=256)
# Sharded and Schur paths: the 60 s DS3 problem over 4 shards of one card,
# with the chunk sizes of bench.py's scaling stage (bench.py:326-368).
SHARDS = 4
SHARD_CHUNKS = dict(obs_chunk=4096, imu_chunk=1024)
RANK_TIMEOUT_S = 600
# Batch CLI: tests/test_batch_cli.py's two recordings.
BATCH_CLI = dict(duration=6.0, cam_fps=10.0, image_size=(640, 360), intrinsics_frames=25,
                 time_offset=-0.08, supersample=2, squares_x=8, squares_y=6,
                 square_length=0.06, marker_length=0.045)
BATCH_CLI_SEEDS = (3, 11)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 CUDA-core FLOP/s.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SOURCE = "openimucameracalibrator_torch/csrc/gram.cu"
REPLACES = "openimucameracalibrator_tpu/solver/pallas_gram.py:119"
K2_SOURCE = "openimucameracalibrator_torch/csrc/corner_nms.cu"
K2_REPLACES = "openimucameracalibrator_tpu/detect/pallas_kernels.py:184"
K3_SOURCE = "openimucameracalibrator_torch/csrc/quad_labels.cu"
K3_REPLACES = ("none: openimucameracalibrator_tpu/detect/video.py:_host_quads runs on the host "
               "(scipy labelling, quads.find_quad_candidates)")


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, warm=3, reps=20):
    """Mean device ms of fn() over reps launches, timed with CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=20):
    """Device ms of one fn() call: reps calls captured in one CUDA graph,
    replayed and timed with CUDA events, so the host's launch gaps between
    calls drop out (what the card spends, not what the Python wrapper
    costs)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def family_shapes(se, problem):
    """(name, K, R, rd, F, segments, L) per family of the DS3 chunk plan, as
    the linearizer hands them to the kernel; and the tangent dimension."""
    plans, _ = se.plan_fast_assembly(problem, 4096, 256)
    out = [(name, plan.n_chunks, plan.chunk * rd, rd, F, segs, L)
           for plan, (name, (rd, F, segs, L)) in zip(
               plans, se.gram_layouts(problem, plans).items())]
    return out, se.build_layout(problem).tangent_dim


def capture_linearizer_inputs(gram, lin, params):
    """{family: (J, r, idx)}: what the linearizer hands the Gram kernel at
    ``params``, caught by swapping ``gram.fused_gram`` for a spy that
    answers with the plain version (so nothing launches the kernel)."""
    captured = {}
    real = gram.fused_gram

    def spy(J, r, idx, segs, L, tag=None):
        captured[tag] = (J.clone(), r.clone(), idx.clone())
        return gram.fused_gram_plain(J, r, idx, segs, L)

    gram.fused_gram = spy
    try:
        lin(params)
    finally:
        gram.fused_gram = real
    return captured


def _random_idx(gen, K, R, rd, segs):
    """Uniformly random run indices, one per measurement of rd rows: no
    locality at all: K1's skip of D's zero blocks finds nothing to skip."""
    import torch

    idx = []
    for s in segs:
        if s[0] == "run":
            _, _, nblk, _, wblk, _ = s
            m = torch.randint(0, wblk - nblk + 1, (K, R // rd), generator=gen, device="cuda")
            idx.append(m.repeat_interleave(rd, dim=1))
    return torch.stack(idx).to(torch.int32).contiguous()


def gram_agrees(gram, name, J, r, idx, segs, L, H, g, note=""):
    """The kernel's (H, g) on one input against the plain version's: returns
    max abs error; exits unless it is within tolerance."""
    import torch

    K, R, F = J.shape
    Hp, gp = gram.fused_gram_plain(J, r, idx, segs, L)
    err_h = (H - Hp).abs().max().item()
    err_g = (g - gp).abs().max().item()
    scale_h, scale_g = Hp.abs().max().item(), gp.abs().max().item()
    # fp32 rounding of an R-term sum, scaled by the largest entry.
    tol = 8.0 * math.sqrt(R) * torch.finfo(torch.float32).eps
    rel_h, rel_g = err_h / scale_h, err_g / scale_g
    log(f"kernel[{name}] K={K} R={R} F={F} L={L} n_run={idx.shape[0]}: "
        f"H max_abs_err={err_h:.3e} rel={rel_h:.3e}, g max_abs_err={err_g:.3e} "
        f"rel={rel_g:.3e} (tolerance rel {tol:.3e}){note}")
    if not (rel_h <= tol and rel_g <= tol and math.isfinite(err_h) and math.isfinite(err_g)):
        raise SystemExit(f"kernel[{name}] disagrees with its plain version")
    return max(err_h, err_g)


def check_gram(gram, name, J, r, idx, segs, L):
    """The kernel against its plain version on one input: returns max abs
    error; exits unless it is within tolerance and two launches agree bit
    for bit."""
    import torch

    H, g = gram.fused_gram(J, r, idx, segs, L)
    H2, g2 = gram.fused_gram(J, r, idx, segs, L)
    torch.cuda.synchronize()
    same_bits = bool(torch.equal(H, H2) and torch.equal(g, g2))
    err = gram_agrees(gram, name, J, r, idx, segs, L, H, g,
                      f"; two launches bit-identical: {same_bits}")
    if not same_bits:
        raise SystemExit(f"kernel[{name}]: two launches differ")
    return err


def checking_gram_spy(gram, checked, label="pipeline's stage 8"):
    """A stand-in for ``gram.fused_gram`` that launches the kernel as the
    path asks (one counted launch per call) and, on the first call of each
    family, holds that launch's result against the plain version on the same
    J, r, idx; ``checked[tag]`` gets the error and the shapes."""
    real = gram.fused_gram

    def spy(J, r, idx, segs, L, tag=None):
        gram.fused_gram = real  # the wrapper counts on gram.fused_gram
        try:
            H, g = real(J, r, idx, segs, L, tag=tag)
        finally:
            gram.fused_gram = spy
        if tag not in checked:
            K, R, F = J.shape
            err = gram_agrees(gram, f"{tag}, {label}", J, r, idx, segs, L, H, g)
            checked[tag] = dict(max_abs_err=err, K=K, R=R, F=F, L=int(L))
        return H, g

    return spy


def time_gram(gram, J, r, idx, segs, L):
    """(kernel device ms, kernel ms per eager call, plain ms, library ms), in
    turns plain, kernel, kernel, library, plain; the kernel's device time
    comes from a CUDA graph of 20 calls (graph_ms), every other time from
    back-to-back eager calls (cuda_ms, the kernels line's ``ms`` since the
    port began); the kernel and the plain version keep their best."""
    import torch

    def library():
        D, rf = gram._densify_segments(r[:, :, None], J[:, :, None, :],
                                       gram._per_row_segments(segs, idx), L)
        return torch.bmm(D.transpose(1, 2), D), torch.bmm(D.transpose(1, 2), rf[..., None])

    def kernel():
        return gram.fused_gram(J, r, idx, segs, L)

    plain_ms = cuda_ms(lambda: gram.fused_gram_plain(J, r, idx, segs, L))
    device_ms, eager_ms = graph_ms(kernel), cuda_ms(kernel)
    device_ms2, eager_ms2 = graph_ms(kernel), cuda_ms(kernel)
    library_ms = cuda_ms(library)
    plain_ms2 = cuda_ms(lambda: gram.fused_gram_plain(J, r, idx, segs, L))
    torch.cuda.empty_cache()
    return (min(device_ms, device_ms2), min(eager_ms, eager_ms2), min(plain_ms, plain_ms2),
            library_ms)


def gram_bound(K, R, F, L, n_run):
    """(bound_ms, bytes ms, operations ms, bytes, operations) of one K1 call:
    each input read once, each output written once; the operations this
    data needs (F nonzeros per row of D: the upper triangle of each row's
    outer product, plus g)."""
    nbytes = K * R * (F + 1 + n_run) * 4 + K * (L * L + L) * 4
    ops = K * R * (F * (F + 1) + 2 * F)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_FLOP_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops, nbytes, ops


def kernel_phase(gram, shapes, captured):
    """K1 against its plain version at each family, on uniformly random idx
    (nothing to skip) and on the linearizer's own inputs at the initial
    point (the main path's idx); returns per-family rows, timed on the
    main path's inputs."""
    import torch

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, K, R, rd, F, segs, L in shapes:
        J = torch.randn((K, R, F), generator=gen, device="cuda")
        r = torch.randn((K, R), generator=gen, device="cuda")
        idx = _random_idx(gen, K, R, rd, segs)
        err_rand = check_gram(gram, f"{name}, random idx", J, r, idx, segs, L)
        rand_device_ms, rand_ms, rand_plain_ms, rand_library_ms = time_gram(gram, J, r, idx,
                                                                            segs, L)
        del J, r, idx

        J, r, idx = captured[name]
        assert tuple(J.shape) == (K, R, F), (name, tuple(J.shape), (K, R, F))
        err_main = check_gram(gram, f"{name}, main-path idx", J, r, idx, segs, L)
        device_ms, kernel_ms, plain_ms, library_ms = time_gram(gram, J, r, idx, segs, L)
        bound_ms, t_bytes, t_ops, nbytes, ops = gram_bound(K, R, F, L, idx.shape[0])
        dense_ops = 2 * K * R * L * L
        log(f"kernel[{name}] main-path idx: kernel_ms={kernel_ms:.4f} (per eager call; "
            f"{device_ms:.4f} device) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f}; random idx: kernel_ms={rand_ms:.4f} (per eager "
            f"call; {rand_device_ms:.4f} device) plain_ms={rand_plain_ms:.4f} "
            f"library_ms={rand_library_ms:.4f}; "
            f"bound_ms={bound_ms:.5f} ({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP; share "
            f"{100 * bound_ms / kernel_ms:.2f} % of the eager time, "
            f"{100 * bound_ms / device_ms:.2f} % of the device time) "
            f"dense_bound_ms={dense_ops / FP32_FLOP_S * 1e3:.4f} ({dense_ops / 1e9:.2f} GFLOP)")
        rows.append(dict(name=f"fused_gram[{name}]", route="cuda", source=SOURCE,
                         replaces=REPLACES, launches=0, max_abs_err=max(err_rand, err_main),
                         ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         library_ms=library_ms, ms_device=device_ms, ms_random_idx=rand_ms,
                         ms_device_random_idx=rand_device_ms,
                         plain_ms_random_idx=rand_plain_ms, tag=name))
        torch.cuda.empty_cache()
    return rows


def build_kernels(*builders):
    """Build the kernels and the GPMF reader at once (one nvcc each, one
    g++; each module's ``build`` or ``library``) and report each build."""
    with concurrent.futures.ThreadPoolExecutor(len(builders)) as ex:
        libs = list(ex.map(lambda b: b(), builders))
    for lib in libs:
        log(f"[build] {lib.path} in {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")


def render_phase(torch, recorded, render, synthetic, device):
    """The intrinsics path's frames, rendered on the card: (times, frames)."""
    t0 = time.perf_counter()
    pose = synthetic.sinusoid_trajectory(np.random.default_rng(3), 60.0, device=device, **TRAJ)
    tex = recorded.BoardTexture(render.render_checkerboard(*SQUARES, 64, 32), 64, 32, 0.04)
    times = np.linspace(0.0, 9.0, N_FRAMES)
    frames = recorded.render_frames(pose, times, "division_undistortion", CAM,
                                    [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0], tex, (960, 540),
                                    supersample=2, noise_std=1.5, seed=3, device=device)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    log(f"[render] {len(frames)} frames 960x540 (supersample 2, noise 1.5 DN) in {sec:.2f} s "
        f"({1e3 * sec / len(frames):.2f} ms per frame)")
    return times, frames


def _same_candidates(name, xy, s, xy_p, s_p, scale):
    """Candidate lists of the kernel and the plain path: the same points and
    the same order, except among scores within 1e-5 * scale of each other,
    of the 0.05 * scale threshold or of a full list's last score (the two
    sum in other orders)."""
    tol = 1e-5 * scale
    xy, s, xy_p, s_p = (a.cpu().numpy() for a in (xy, s, xy_p, s_p))
    cut = max(0.05 * scale, s_p[-1] if s_p[-1] > 0 else 0.0) + tol

    def points(xy_, s_, floor):
        return {tuple(p) for p, v in zip(xy_, s_) if v > floor}

    ok_set = (points(xy, s, cut) <= points(xy_p, s_p, 0.0)
              and points(xy_p, s_p, cut) <= points(xy, s, 0.0))
    apart = s_p > cut
    apart[1:] &= s_p[:-1] - s_p[1:] > tol
    apart[:-1] &= s_p[:-1] - s_p[1:] > tol
    ok_order = bool(np.all(xy[apart] == xy_p[apart]))
    log(f"[K2] {name}: {int((s_p > 0).sum())} candidates (plain), {int((s > 0).sum())} "
        f"(kernel); same points: {ok_set}; same order where scores are apart: {ok_order}")
    return ok_set and ok_order


def k2_phase(torch, kernels, frame):
    """K2 against its plain version at 960x540 on a rendered frame and a
    random one; returns the kernels-line row (launches filled in later)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"rendered": torch.as_tensor(frame.astype(np.float32), device="cuda"),
              "random": 255.0 * torch.rand((540, 960), generator=gen, device="cuda")}
    errs, ok = [], True
    # (6, 4) is what every caller passes; (5, 3) runs the generic instantiation.
    cases = [(name, x, 6, 4) for name, x in inputs.items()]
    cases.append(("rendered, generic instantiation", inputs["rendered"], 5, 3))
    for name, x, radius, nms in cases:
        resp, keep = kernels.corner_response_nms(x, radius, nms)
        torch.cuda.synchronize()
        resp_p, keep_p = kernels.corner_response_nms_plain(x, radius, nms)
        scale = resp_p.abs().max().item()
        err = (resp - resp_p).abs().max().item()
        local_max = torch.nn.functional.max_pool2d(resp_p[None, None], 2 * nms + 1, 1,
                                                   nms)[0, 0]
        agree = (keep == keep_p).float().mean().item()
        clear = (resp_p - local_max).abs() > 1e-4 * scale
        exact = bool(torch.equal(keep[clear], keep_p[clear]))
        log(f"[K2] {name} (radius {radius}, nms {nms}): resp max_abs_err={err:.3e} "
            f"(tolerance {2e-5 * scale:.3e} = 2e-5 * max|resp|), keep agreement {agree:.6f} "
            f"(>= 0.999), exact where |resp - local max| > 1e-4 * max|resp|: {exact}")
        ok &= err <= 2e-5 * scale and math.isfinite(err) and agree >= 0.999 and exact
        if radius == 6:
            cand = kernels.find_corner_candidates_kernel(x)
            cand_p = kernels.top_candidates(resp_p, keep_p, 512, 0.05)
            ok &= _same_candidates(name, *cand, *cand_p, scale)
            errs.append(err)
    if not ok:
        raise SystemExit("K2 disagrees with its plain version")

    x = inputs["rendered"]
    H, W = x.shape

    def kernel():
        return kernels.corner_response_nms(x)

    plain_ms = cuda_ms(lambda: kernels.corner_response_nms_plain(x))
    kernel_ms, eager_ms = graph_ms(kernel), cuda_ms(kernel)
    kernel_ms2, eager_ms2 = graph_ms(kernel), cuda_ms(kernel)
    plain_ms2 = cuda_ms(lambda: kernels.corner_response_nms_plain(x))
    resp, keep = kernels.corner_response_nms(x)
    sort_ms = cuda_ms(lambda: kernels.top_candidates(resp, keep, 512, 0.05))
    # Least time for the same work: the frame read once, resp and keep
    # written once; per pixel the operations of the separable form (each
    # quadrant kernel is a Gaussian, a product of one factor per axis, on a
    # quadrant of the window; taps are 2 operations, an FMA):
    # - angle 0: a row pass (2 half-rows of r taps) then a column pass (4
    #   quadrants of r taps): 6r taps;
    # - pi/4: in u = y - x, v = x + y the quadrants are the triangles
    #   1 <= |u|, |v| and |u| + |v| <= 2r (u, v of one parity): per
    #   direction of v one pass of running sums along v (2r - 1 taps, one per
    #   prefix both parities need), then per quadrant one pass along u (2r - 1
    #   taps): 6(2r - 1) taps;
    # - the response reduction as the plain version writes it: 15 per
    #   prototype, the max of the two and the clamp: 32;
    # - the (2n+1)^2 max, separable, van Herk / Gil-Werman: 3 per axis, and
    #   the comparison with it: 7.
    r_ = 6
    n_taps = 6 * r_ + 6 * (2 * r_ - 1)
    direct_taps = int((kernels._tap_tables(r_)[2] != 0).sum())
    nbytes = H * W * 4 * 3
    ops = H * W * (2 * n_taps + 32 + 7)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_FLOP_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    plain = min(plain_ms, plain_ms2)
    eager = min(eager_ms, eager_ms2)
    device = min(kernel_ms, kernel_ms2)
    log(f"[K2] 960x540: kernel_ms={eager_ms:.4f},{eager_ms2:.4f} (per eager call; "
        f"{kernel_ms:.4f},{kernel_ms2:.4f} device, CUDA graph of 20 calls) plain_ms="
        f"{plain_ms:.4f},{plain_ms2:.4f} (the plain version, F.conv2d + F.max_pool2d on cuDNN, "
        f"TF32 off, is also the library yardstick: library_ms = plain_ms) candidate "
        f"sort+threshold {sort_ms:.4f} ms; bound_ms={bound_ms:.5f} (share "
        f"{100 * bound_ms / eager:.2f} % of the eager time, {100 * bound_ms / device:.2f} % of "
        f"the device time) ({'bytes' if t_bytes >= t_ops else 'operations'}: bytes "
        f"{nbytes / 1e6:.2f} MB -> {t_bytes * 1e3:.3f} us, operations {ops / 1e9:.4f} GFLOP -> "
        f"{t_ops * 1e3:.3f} us; {n_taps} taps per pixel in the separable form, "
        f"{direct_taps} direct)")
    return dict(name="corner_response_nms", route="cuda", source=K2_SOURCE,
                replaces=K2_REPLACES, launches=0, max_abs_err=max(errs),
                ms=eager, plain_ms=plain, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=plain,
                ms_device=device)


def intrinsics_phase(torch, mods, times, frames, tmp):
    """extract_board + the calibrate_camera CLI on the card; checks recovery
    and returns K2's launches during the run."""
    board_extractor, checkerboard, kernels, io, cal_cli = mods
    opts = board_extractor.BoardExtractorOptions(board_type="radon", squares_x=SQUARES[0],
                                                 squares_y=SQUARES[1])
    kernels.reset_counts()
    checkerboard.reset_phase_seconds()
    t0 = time.perf_counter()
    ds = board_extractor.extract_board(zip(times, frames), opts, fps=30.0, device="cuda")
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    launches = kernels.corner_response_nms.launches
    n = len(frames)
    full = int(ds.valid.all(-1).sum())
    ph = {k: 1e3 * v / n for k, v in checkerboard.phase_seconds.items()}
    log(f"[intrinsics] detection {det_s:.2f} s, {1e3 * det_s / n:.2f} ms per frame: kernel + "
        f"candidate sort {ph['candidates']:.2f} ms, subpixel refinement {ph['refine']:.2f} ms, "
        f"host lattice {ph['lattice']:.2f} ms; full grid in {full} of {n} frames; "
        f"corner_response_nms launches {launches}")
    corners = os.path.join(tmp, "radon_corners.uson")
    calib_json = os.path.join(tmp, "radon_calib.json")
    io.save_corners(ds, corners)
    t0 = time.perf_counter()
    cal_cli.main(["--input_corners", corners, "--save_path_calib_dataset", calib_json,
                  "--grid_size", "0.01", "--device", "cuda"])
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    calib = io.load_camera_calibration(calib_json)
    with open(calib_json) as f:
        views = json.load(f)["nr_calib_images"]
    f_, cx, cy, d = (float(v) for v in calib.params)
    err = calib.mean_reproj_error
    log(f"[intrinsics] calibrate_camera CLI {cal_s:.2f} s: f={f_:.4f} cx={cx:.4f} cy={cy:.4f} "
        f"d={d:.5e} (truth {CAM}), mean reprojection error {err:.4f} px, {views} views")
    checks = {
        "full grid in >= 40% of frames": full >= 0.4 * n,
        ">= 20 active views": views >= 20,
        "one K2 launch per frame": launches == n,
        "|f - truth| < 1 px": abs(f_ - CAM[0]) < 1.0,
        "|cx - truth| < 1.5 px and |cy - truth| < 1.5 px":
            abs(cx - CAM[1]) < 1.5 and abs(cy - CAM[2]) < 1.5,
        "|d - truth| < 3% of |truth|": abs(d - CAM[3]) < 0.03 * abs(CAM[3]),
        "mean reprojection error < 0.15 px": err < 0.15,
        "finite result": all(math.isfinite(v) for v in (f_, cx, cy, d, err)),
    }
    for k, ok in checks.items():
        log(f"[intrinsics] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("intrinsics path checks failed")
    return launches


def init_stages(torch, mods, corners, calib, scene, imu, label):
    """Stages 5 and 7 alone on the card, timed; returns their errors
    against the scene's truth (90th percentiles for the poses)."""
    pose_estimator, imu_cam_rotation, lie = mods
    n_cost = [0]
    real_cost = imu_cam_rotation._alignment_cost

    def counting_cost(*args):
        n_cost[0] += 1
        return real_cost(*args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    poses = pose_estimator.estimate_poses(corners, calib, device="cuda")
    torch.cuda.synchronize()
    pose_s = time.perf_counter() - t0
    pose_mem = torch.cuda.max_memory_allocated() / 2**30
    imu_cam_rotation._alignment_cost = counting_cost
    try:
        t0 = time.perf_counter()
        init = imu_cam_rotation.estimate_imu_to_camera_rotation(poses, imu, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    finally:
        imu_cam_rotation._alignment_cost = real_cost
    n = len(poses.times)
    v = poses.valid
    t90 = float(np.percentile(np.linalg.norm(poses.t_w_c[v] - scene.t_w_c[v], axis=-1), 90))
    r90 = float(np.percentile(torch.linalg.vector_norm(lie.quat_boxminus(
        torch.as_tensor(poses.q_w_c[v]), torch.as_tensor(scene.q_w_c[v])), dim=-1).numpy(), 90))
    q_want = lie.quat_conjugate(torch.as_tensor(scene.q_i_c))
    rot_err = float(torch.linalg.vector_norm(lie.quat_boxminus(
        torch.as_tensor(init.q_gyro_to_cam), q_want)))
    dt_err = abs(init.time_offset - scene.time_offset)
    out = dict(valid_share=float(poses.valid.mean()), t90=t90, r90=r90, rot_err=rot_err,
               dt_err=dt_err)
    log(f"[pipeline] {label}: estimate_poses {pose_s:.3f} s for {n} views "
        f"({1e3 * pose_s / n:.3f} ms per view; peak device memory {pose_mem:.2f} GiB), "
        f"{int(poses.valid.sum())} valid; 90th-percentile pose error {t90 * 1e3:.3f} mm, "
        f"{r90 * 1e3:.3f} mrad; estimate_imu_to_camera_rotation {init_s:.3f} s, "
        f"{n_cost[0]} cost evaluations ({1e3 * init_s / n_cost[0]:.3f} ms each): time offset "
        f"{init.time_offset:+.6f} s (error {dt_err * 1e3:.3f} ms), rotation error "
        f"{rot_err * 1e3:.3f} mrad, gyro bias {init.gyro_bias.tolist()}")
    return out


def pipeline_phase(torch, mods, st, cam_corners, tmp):
    """The run_calibration CLI on the card with its default board (charuco)
    from seeded corner files, with K1's first launch of each family held
    against its plain version at the shapes the pipeline's own SEW gives
    it; then stages 5 and 7 alone. Checks every bar; returns K1's launches
    by family during the CLI run, K1's check per family, K2's launches
    (2-D, block mode) and K3's counters during the run."""
    (run_cal, imu_camera_calibrator, pose_estimator, imu_cam_rotation, se, gram, kernels,
     quad_kernels, io, lie, synthetic, cameras) = mods
    scene = st.scene
    ws = os.path.join(tmp, "pipeline_ws")
    os.makedirs(ws)
    shutil.copy(cam_corners, os.path.join(ws, "cam_corners.uson"))
    shutil.copy(st.paths["input_corners"], os.path.join(ws, "imu_cam_corners.uson"))

    captured = {}
    real = imu_camera_calibrator.calibrate_imu_camera

    def spy(corners, calib, poses, imu, init, sew, **kw):
        captured.update(poses=poses, init=init, sew=sew)
        captured["result"] = real(corners, calib, poses, imu, init, sew, **kw)
        return captured["result"]

    gram_checked = {}
    real_gram = gram.fused_gram
    gram.reset_counts()
    kernels.reset_counts()
    quad_kernels.reset_counts()
    imu_camera_calibrator.calibrate_imu_camera = spy
    gram.fused_gram = checking_gram_spy(gram, gram_checked)
    try:
        t0 = time.perf_counter()
        summary = run_cal.main([
            "--path_calib_dataset", tmp, "--telemetry_json", st.paths["telemetry_json"],
            "--telemetry_format", "generic", "--camera_model", "DIVISION_UNDISTORTION",
            "--num_squares_x", str(SQUARES[0]),
            "--num_squares_y", str(SQUARES[1]), "--voxel_grid_size", "0.01",
            "--workspace", ws, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        imu_camera_calibrator.calibrate_imu_camera = real
        gram.fused_gram = real_gram
    counts = dict(gram.fused_gram.launches_by_tag)
    launches = gram.fused_gram.launches
    k2_launches = (kernels.corner_response_nms.launches, kernels.corner_response_block.launches)
    k3 = k3_counts(quad_kernels)
    res, sew, init, poses = (captured[k] for k in ("result", "sew", "init", "poses"))
    shapes, D = family_shapes(se, res.problem)
    n_lin = sum(s["linearizations"] for s in res.stages)
    log(f"[pipeline] run_calibration CLI wall {wall:.2f} s; stage_timings_s "
        f"{json.dumps(summary['stage_timings_s'])}")
    log(f"[pipeline] stage 1: {summary['intrinsics_reproj_error_px']:.4f} px, params "
        f"{summary['intrinsics_params']}; stage 4: biases {summary['bias_estimate']}; "
        f"stage 5: {int(poses.valid.sum())} of {len(poses.valid)} poses; stage 6: dt_so3 "
        f"{sew.dt_so3} s, dt_r3 {sew.dt_r3} s, std_so3 {sew.std_so3}, std_r3 {sew.std_r3}; "
        f"stage 7: time offset {init.time_offset:+.6f} s")
    log(f"[pipeline] stage 8: tangent dim D={D}; chunk plan: " + "; ".join(
        f"{n} K={K} R={R} F={F} L={L}" for n, K, R, _, F, _, L in shapes))
    log(f"[pipeline] default board (charuco); corner_response_nms launches {k2_launches[0]}, "
        f"corner_response_block launches {k2_launches[1]}, K3 launches {k3[0]}, frames {k3[1]}, "
        f"truncated_frames {k3[2]} (the corners come from the seeded workspace)")
    for i, s in enumerate(res.stages):
        log(f"[pipeline] stage 8 LM stage {i}: {s['iterations']} iterations, {s['status']}, "
            f"{s['seconds']:.3f} s wall, {s['linearizations']} linearizations")
    q = torch.tensor(summary["q_i_c"], dtype=torch.float64)
    rot_err = float(torch.linalg.vector_norm(lie.quat_boxminus(
        q, torch.as_tensor(scene.q_i_c, dtype=torch.float64))))
    dt_err = abs(summary["time_offset_s"] - TIME_OFFSET)
    ld = summary["line_delay_us"] * 1e-6
    reproj = summary["final_reproj_error_px"]
    t_err = np.abs(np.asarray(summary["t_i_c"]) - scene.t_i_c)
    g_norm = float(np.linalg.norm(summary["gravity"]))
    log(f"[pipeline] stage 8: rotation error {rot_err:.2e} rad, time offset error "
        f"{dt_err * 1e3:.3f} ms, line delay {ld * 1e6:.3f} us (truth {LINE_DELAY * 1e6:.3f}), "
        f"mean reprojection error {reproj:.4f} px, t_i_c error {t_err.tolist()} m, "
        f"|gravity| {g_norm:.4f}; fused_gram launches {launches} ({counts}) for {n_lin} "
        f"linearizations")
    numbers = [reproj, ld, summary["time_offset_s"], summary["intrinsics_reproj_error_px"],
               sew.dt_so3, sew.dt_r3, sew.std_so3, sew.std_r3] + summary["t_i_c"] \
        + summary["gravity"] + summary["q_i_c"]
    checks = {
        "intrinsics reprojection error < 0.15 px": summary["intrinsics_reproj_error_px"] < 0.15,
        "stage 6: dt_so3 in [0.01, 0.2] s and dt_r3 in [0.01, 0.15] s":
            0.01 <= sew.dt_so3 <= 0.2 and 0.01 <= sew.dt_r3 <= 0.15,
        "rotation error < 0.01 rad": rot_err < 0.01,
        "|time offset - truth| < 2 ms": dt_err < 2e-3,
        "line delay within 30% of truth": abs(ld - LINE_DELAY) < 0.3 * LINE_DELAY,
        "mean reprojection error < 0.35 px": reproj < 0.35,
        "t_i_c within 5 mm per axis": bool(np.all(t_err < 5e-3)),
        "|gravity| within 0.05 of 9.81": abs(g_norm - 9.81) < 0.05,
        "finite result": all(math.isfinite(v) for v in numbers),
        "3 kernel launches per linearization": n_lin > 0 and launches == 3 * n_lin and all(
            counts.get(f, 0) == n_lin for f in ("obs", "accel", "gyro")),
        "fused_gram held against its plain version at each family's shapes":
            sorted(gram_checked) == ["accel", "gyro", "obs"],
        "one K3 launch per K2 block launch, 32 frames each":
            k3[0] == k2_launches[1] and k3[1] == 32 * k3[0],
    }

    # Stages 5 and 7 alone on the pipeline's inputs: timed; the DS3 scene
    # has a rolling shutter (16.7 ms readout), which neither stage models.
    calib = io.load_camera_calibration(os.path.join(ws, "cam_calib.json"))
    corners = io.load_corners(st.paths["input_corners"])
    stage_mods = (pose_estimator, imu_cam_rotation, lie)
    rs = init_stages(torch, stage_mods, corners, calib, scene, st.imu,
                     "pipeline inputs (rolling shutter)")
    # The same scene with a global shutter: the JAX tests' condition.
    gs_scene = synthetic.make_imu_camera_scene(
        cameras.get_model("division_undistortion"), CAM, duration=DURATION,
        cam_fps=CAM_FPS, imu_rate=IMU_RATE, image_size=(960, 540), noise_px=0.2,
        time_offset=TIME_OFFSET, line_delay=0.0, seed=7, device="cuda")
    gs_corners = dataclasses.replace(corners, points2d=gs_scene.observations,
                                     valid=gs_scene.obs_valid)
    gs_imu = dataclasses.replace(st.imu, times=gs_scene.imu_times, accel=gs_scene.accel,
                                 gyro=gs_scene.gyro)
    gs = init_stages(torch, stage_mods, gs_corners, calib, gs_scene, gs_imu,
                     "same scene, global shutter")
    checks.update({
        "stage 5 (rolling shutter): >= 80% of views valid": rs["valid_share"] >= 0.8,
        "stage 5 (global shutter): >= 80% of views valid": gs["valid_share"] >= 0.8,
        "stage 5 (global shutter): 90th-percentile pose errors < 8 mm and < 8 mrad":
            gs["t90"] < 0.008 and gs["r90"] < 0.008,
        "stage 7 (global shutter): |time offset - truth| < 4 ms": gs["dt_err"] < 4e-3,
        "stage 7 (global shutter): rotation error < 0.02 rad": gs["rot_err"] < 0.02,
    })
    for k, ok in checks.items():
        log(f"[pipeline] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("pipeline checks failed")
    return counts, gram_checked, k2_launches, k3


def banded_phase(torch, mods, tmp):
    """The DS3 recording cut to BANDED_DURATION (D ~ 28.4k, where the port
    used to raise): one linearization at the initial point; the banded and
    the dense damped solve on the same (H, g, lambda) against each other
    and against a float64 dense solve; then the stage-8 CLI on that scene
    through the banded solve, with its bars, wall and K1 launches. Returns
    K1's launches by family during the CLI run."""
    se, banded, lm, gram, cli, io, lie = mods
    d = os.path.join(tmp, "banded")
    os.makedirs(d)
    st = stage8_setup(torch, "cuda", d, duration=BANDED_DURATION)
    layout = se.build_layout(st.problem)
    D = layout.tangent_dim
    H, g, _ = st.lin(st.params0)
    mask = layout.free_mask(se.flags_to_fixed(se.DEFAULT_FLAGS), dtype=H.dtype, device="cuda")
    H, g = lm._mask_system(H, g, mask)
    lam = torch.tensor(BANDED_LAM, dtype=H.dtype, device="cuda")
    t0 = time.perf_counter()
    struct = banded.from_problem(layout, st.problem, se.ORDER)
    struct_s = time.perf_counter() - t0
    if struct is None:
        raise SystemExit(f"banded: no slab decomposition at D={D}")
    d_band = banded.make_banded_solver(struct)(H, g, lam)
    d_dense = lm._solve_damped(H, g, lam)
    torch.cuda.synchronize()
    d_64 = lm._solve_damped(H.double(), g.double(), lam.double())
    del H, g
    torch.cuda.empty_cache()

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))

    e_band, e_dense = rel(d_band, d_64), rel(d_dense, d_64)
    e_pair = rel(d_band, d_dense.double())
    K, smax = struct.idx.shape
    log(f"[banded] {BANDED_DURATION:.0f} s, D={D}: {K} slabs of <= {smax} coordinates, tail "
        f"{struct.tail.shape[0]}; from_problem {struct_s:.3f} s; lambda {BANDED_LAM}: "
        f"|banded - dense| / |dense| = {e_pair:.3e} (tolerance 1e-3), against the float64 dense "
        f"step: banded {e_band:.3e}, dense {e_dense:.3e} (tolerance: banded <= 2 x dense + 1e-6)")
    if not (e_pair < 1e-3 and e_band <= 2 * e_dense + 1e-6 and math.isfinite(e_band)):
        raise SystemExit("banded: the banded step disagrees with the dense one")
    del d_band, d_dense, d_64

    # The CLI through the banded solve, which "auto" takes from D >=
    # BANDED_MIN_DIM (the sweep's crossover, below this D).
    n_solves = [0]
    real_make = banded.make_banded_solver

    def counting_make(struct_):
        solve = real_make(struct_)

        def counted(*args):
            n_solves[0] += 1
            return solve(*args)

        return counted

    out = os.path.join(d, "result.json")
    argv = sum([[f"--{k}", v] for k, v in st.paths.items()], [])
    argv += ["--output_path", out, "--device", "cuda"]
    gram.reset_counts()
    banded.make_banded_solver = counting_make
    try:
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        banded.make_banded_solver = real_make
    counts = dict(gram.fused_gram.launches_by_tag)
    launches = gram.fused_gram.launches
    res = io.load_imu_camera_result(out)
    stages = res["lm_stages"]
    n_lin = sum(s_["linearizations"] for s_ in stages)
    for i, s_ in enumerate(stages):
        log(f"[banded] LM stage {i}: {s_['iterations']} iterations, {s_['status']}, "
            f"{s_['seconds']:.3f} s wall, {s_['linearizations']} linearizations")
    q = torch.tensor([res["q_i_c"][k] for k in "wxyz"], dtype=torch.float64)
    rot_err = float(torch.linalg.vector_norm(lie.quat_boxminus(
        q, torch.as_tensor(st.scene.q_i_c, dtype=torch.float64))))
    dt_err = abs(res["time_offset_imu_to_cam_s"] - TIME_OFFSET)
    ld, reproj = res["cam_line_delay"], res["final_reproj_error"]
    log(f"[banded] stage-8 CLI (BANDED_MIN_DIM {se.BANDED_MIN_DIM}, D={D}) wall {wall:.2f} s; "
        f"{n_solves[0]} banded solves; rotation error "
        f"{rot_err:.2e} rad, time offset error {dt_err * 1e3:.3f} ms, line delay "
        f"{ld * 1e6:.3f} us (truth {LINE_DELAY * 1e6:.3f}), mean reprojection error "
        f"{reproj:.4f} px; fused_gram launches {launches} ({counts}) for {n_lin} linearizations")
    checks = {
        "rotation error < 0.01 rad": rot_err < 0.01,
        "|time offset - truth| < 2 ms": dt_err < 2e-3,
        "line delay within 30% of truth": abs(ld - LINE_DELAY) < 0.3 * LINE_DELAY,
        "mean reprojection error < 0.35 px": reproj < 0.35,
        "finite result": all(math.isfinite(v) for v in
                             [reproj, ld, res["final_cost"]] + list(res["t_i_c"].values())),
        "3 kernel launches per linearization": n_lin > 0 and launches == 3 * n_lin and all(
            counts.get(f, 0) == n_lin for f in ("obs", "accel", "gyro")),
        "every damped solve banded (one per LM iteration)":
            n_solves[0] == sum(s_["iterations"] for s_ in stages) > 0,
    }
    for k, ok in checks.items():
        log(f"[banded] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("banded path checks failed")
    del st
    torch.cuda.empty_cache()
    return counts


def charuco_truth(torch, pose, times, cameras, lie, spec):
    """(V, N, 2) pixel positions of the charuco corners in each frame of the
    global-shutter render (identity extrinsics, no time offset)."""
    dev = "cuda"
    q, p = pose(torch.as_tensor(np.asarray(times, np.float64), device=dev))
    X = torch.as_tensor(np.concatenate([spec.chessboard_corners(),
                                        np.zeros((spec.chessboard_corners().shape[0], 1))], 1),
                        device=dev)
    Xc = lie.quat_rotate(lie.quat_conjugate(q)[:, None, :], X[None] - p[:, None, :])
    uv, _ = cameras.get_model("division_undistortion").project(
        torch.as_tensor(CAM, dtype=torch.float64, device=dev), Xc)
    return uv.cpu().numpy()


def k2_block_phase(torch, kernels, block):
    """K2's block mode against its plain version on one block of the
    charuco frames; times; the kernels-line row (launches filled in later)."""
    x = torch.as_tensor(block.astype(np.float32), device="cuda")
    resp = kernels.corner_response_block(x)
    resp_p = kernels.corner_response_block_plain(x)
    torch.cuda.synchronize()
    scale = resp_p.abs().max().item()
    err = (resp - resp_p).abs().max().item()
    same_2d = bool(torch.equal(resp[0], kernels.corner_response_nms(x[0].contiguous())[0]))
    resp5 = kernels.corner_response_block(x[:4], 5)
    err5 = (resp5 - kernels.corner_response_block_plain(x[:4], 5)).abs().max().item()
    scale5 = resp5.abs().max().item()
    log(f"[K2 block] {tuple(x.shape)}: resp max_abs_err={err:.3e} (tolerance {2e-5 * scale:.3e} "
        f"= 2e-5 * max|resp|); frame 0 equals the 2-D kernel's response bit for bit: {same_2d}; "
        f"radius 5 (generic instantiation) on 4 frames: max_abs_err={err5:.3e} (tolerance "
        f"{2e-5 * scale5:.3e})")
    if not (err <= 2e-5 * scale and err5 <= 2e-5 * scale5 and math.isfinite(err) and same_2d):
        raise SystemExit("K2 block mode disagrees with its plain version")
    bank = torch.as_tensor(kernels.image_mod._prototype_bank(6), device="cuda")
    bank = bank.reshape(8, 1, 13, 13)

    def library():
        return torch.nn.functional.conv2d(x[:, None], bank, padding=6)

    def kernel():
        return kernels.corner_response_block(x)

    plain_ms = cuda_ms(lambda: kernels.corner_response_block_plain(x))
    device_ms, eager_ms = graph_ms(kernel), cuda_ms(kernel)
    device_ms2, eager_ms2 = graph_ms(kernel), cuda_ms(kernel)
    library_ms = cuda_ms(library)
    plain_ms2 = cuda_ms(lambda: kernels.corner_response_block_plain(x))
    # Least time for the same work: the block read once and the response
    # written once; per pixel the separable form's operations (k2_phase)
    # and the response reduction, without the NMS.
    Fn, H, W = x.shape
    n_taps = 6 * 6 + 6 * (2 * 6 - 1)
    nbytes = Fn * H * W * 4 * 2
    ops = Fn * H * W * (2 * n_taps + 32)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_FLOP_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    eager, device, plain = min(eager_ms, eager_ms2), min(device_ms, device_ms2), min(plain_ms,
                                                                                    plain_ms2)
    log(f"[K2 block] {Fn}x{H}x{W}: kernel_ms={eager_ms:.4f},{eager_ms2:.4f} (per eager call; "
        f"{device_ms:.4f},{device_ms2:.4f} device, CUDA graph of 20 calls) plain_ms="
        f"{plain_ms:.4f},{plain_ms2:.4f} library_ms={library_ms:.4f} (cuDNN F.conv2d of the 8 "
        f"quadrant kernels over the block, TF32 off: the correlations alone); bound_ms="
        f"{bound_ms:.5f} ({'bytes' if t_bytes >= t_ops else 'operations'}: bytes "
        f"{nbytes / 1e6:.1f} MB -> {t_bytes * 1e3:.2f} us, operations {ops / 1e9:.3f} GFLOP -> "
        f"{t_ops * 1e3:.2f} us); share {100 * bound_ms / eager:.2f} % of the eager time, "
        f"{100 * bound_ms / device:.2f} % of the device time")
    return dict(name="corner_response_block", route="cuda", source=K2_SOURCE,
                replaces=K2_REPLACES, launches=0, max_abs_err=max(err, err5), ms=eager,
                plain_ms=plain, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms,
                ms_device=device, shape=[Fn, H, W])


def charuco_phase(torch, mods, tmp):
    """The charuco intrinsics path on the card: 300 rendered frames of the
    10x8 charuco board, extract_board on the batched video path, corners
    against the render's truth, per-stage detection times, K2's block mode
    against its plain version, K3 against the host quad stage, and the
    calibrate_camera CLI. Returns the block-mode row, K3's row and the
    corner file."""
    (board_extractor, video, kernels, quad_kernels, io, cal_cli, recorded, synthetic, cameras,
     lie) = mods
    times, frames, pose = charuco_frames(torch, recorded, synthetic, N_FRAMES)
    opts = charuco_options(board_extractor)
    kernels.reset_counts()
    quad_kernels.reset_counts()
    t0 = time.perf_counter()
    ds = board_extractor.extract_board(zip(times, frames), opts, fps=30.0, device="cuda")
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    block_launches = kernels.corner_response_block.launches
    nms_launches = kernels.corner_response_nms.launches
    k3 = quad_kernels.quad_candidates_block
    k3_counts = (k3.launches, k3.frames, k3.truncated_frames)
    log(f"[charuco] K3 launches {k3_counts[0]}, frames labelled {k3_counts[1]}, truncated "
        f"frames {k3_counts[2]}")
    spec = board_extractor._charuco_spec(opts)
    truth = charuco_truth(torch, pose, times, cameras, lie, spec)
    err = np.linalg.norm(ds.points2d - truth, axis=-1)[ds.valid]
    n = len(frames)
    per_frame = ds.valid.sum(1)
    good = int((per_frame >= 55).sum())
    log(f"[charuco] extract_board (batched, 32 frames per block) {det_s:.2f} s, "
        f"{1e3 * det_s / n:.2f} ms per frame; corners per frame: mean {per_frame.mean():.2f}, "
        f">= 55 of 63 in {good} of {n} frames; error against the render's truth: mean "
        f"{err.mean():.4f} px, max {err.max():.4f} px over {err.size} corners; "
        f"corner_response_block launches {block_launches}, corner_response_nms {nms_launches}")
    bench = video.benchmark_block(np.stack(frames[:32]), spec,
                                  video.VideoDetectorOptions(batch_frames=32), device="cuda")
    log("[charuco] per 32-frame block (benchmark_block, mean of 5, ms per frame): " + ", ".join(
        f"{k[:-3]} {v / 32:.3f}" for k, v in bench.items() if k.endswith("_ms"))
        + f"; device-resident {bench['device_resident_fps']:.1f} frames/s; block ms "
        + json.dumps({k: v for k, v in bench.items() if k.endswith("_ms")}))
    row = k2_block_phase(torch, kernels, np.stack(frames[:32]))
    row["launches"] = block_launches
    row["detect_ms_per_frame"] = {k[:-3]: v / 32 for k, v in bench.items() if k.endswith("_ms")}
    k3_row = k3_phase(torch, video, quad_kernels, np.stack(frames[:32]), spec)
    k3_row["launches"] = k3_counts[0]
    del frames

    corners = os.path.join(tmp, "charuco_corners.uson")
    calib_json = os.path.join(tmp, "charuco_calib.json")
    io.save_corners(ds, corners)
    t0 = time.perf_counter()
    cal_cli.main(["--input_corners", corners, "--save_path_calib_dataset", calib_json,
                  "--grid_size", "0.01", "--device", "cuda"])
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    calib = io.load_camera_calibration(calib_json)
    with open(calib_json) as f:
        views = json.load(f)["nr_calib_images"]
    f_, cx, cy, dd = (float(v) for v in calib.params)
    rerr = calib.mean_reproj_error
    log(f"[charuco] calibrate_camera CLI {cal_s:.2f} s: f={f_:.4f} cx={cx:.4f} cy={cy:.4f} "
        f"d={dd:.5e} (truth {CAM}), mean reprojection error {rerr:.4f} px, {views} views")
    checks = {
        ">= 55 of 63 corners in >= 40% of frames": good >= 0.4 * n,
        "mean corner error < 0.25 px": err.mean() < 0.25,
        "max corner error < 0.6 px": err.max() < 0.6,
        "one K2 block launch per block of 32 frames": block_launches == math.ceil(n / 32)
        and nms_launches == 0,
        "one K3 launch per block of 32 frames":
            k3_counts[:2] == (math.ceil(n / 32), 32 * math.ceil(n / 32)),
        ">= 20 active views": views >= 20,
        "|f - truth| < 1 px": abs(f_ - CAM[0]) < 1.0,
        "|cx - truth| < 1.5 px and |cy - truth| < 1.5 px":
            abs(cx - CAM[1]) < 1.5 and abs(cy - CAM[2]) < 1.5,
        "|d - truth| < 3% of |truth|": abs(dd - CAM[3]) < 0.03 * abs(CAM[3]),
        "mean reprojection error < 0.15 px": rerr < 0.15,
        "finite result": all(math.isfinite(v) for v in (f_, cx, cy, dd, rerr)),
    }
    for k, ok in checks.items():
        log(f"[charuco] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("charuco path checks failed")
    return row, k3_row, corners


def charuco_frames(torch, recorded, synthetic, n):
    """The charuco intrinsics path's first n frames, rendered on the card:
    (times, frames, the trajectory)."""
    t0 = time.perf_counter()
    pose = synthetic.sinusoid_trajectory(np.random.default_rng(3), 60.0, device="cuda", **TRAJ)
    tex = recorded.charuco_texture(*SQUARES, CHARUCO["square_length"],
                                   CHARUCO["marker_length"], 64, 32)
    times = np.linspace(0.0, 9.0, N_FRAMES)[:n]
    frames = recorded.render_frames(pose, times, "division_undistortion", CAM,
                                    [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0], tex, (960, 540),
                                    supersample=2, noise_std=1.5, seed=3, device="cuda")
    torch.cuda.synchronize()
    log(f"[charuco] {len(frames)} frames 960x540 of the 10x8 charuco board (0.04 m squares, "
        f"0.03 m markers, DICT_ARUCO_ORIGINAL) rendered in {time.perf_counter() - t0:.2f} s")
    return times, frames, pose


def charuco_options(board_extractor):
    return board_extractor.BoardExtractorOptions(board_type="charuco", squares_x=SQUARES[0],
                                                 squares_y=SQUARES[1], batch_frames=32,
                                                 **CHARUCO)


def host_ms(fn, reps=5):
    """Mean host-clock ms of fn() (host work that ends in host results)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def k3_phase(torch, video, quad_kernels, block, spec):
    """K3 against the host route on one block of charuco frames: the same
    quads and validity, exactly; times; the kernels-line row (launches
    filled in by the caller)."""
    opts = video.VideoDetectorOptions(batch_frames=block.shape[0])
    board = video._Board(spec, opts, torch.device("cuda"))
    stack = torch.as_tensor(block, device="cuda")
    _, maskd, _ = board.pixels(stack, False)
    _, packed, _ = board.pixels(stack, True)
    quad_kernels.reset_counts()
    quads_b, qvalid, n_kept = board.quads(maskd)
    torch.cuda.synchronize()
    mask_np = maskd.cpu().numpy()
    want_q, want_v = video._host_quads(mask_np, opts)
    same = (np.array_equal(quads_b.cpu().numpy(), want_q)
            and np.array_equal(qvalid.cpu().numpy(), want_v))
    n_kept = n_kept.cpu().numpy()
    quad_kernels.count_truncated(n_kept, opts.max_quads)
    k3 = quad_kernels.quad_candidates_block
    log(f"[K3] {tuple(maskd.shape)}: quads and qvalid equal the host route's exactly: {same}; "
        f"valid quads per frame {int(want_v.sum(1).min())}-{int(want_v.sum(1).max())}, "
        f"components in the area limits {int(n_kept.min())}-{int(n_kept.max())}; counters: "
        f"launches {k3.launches}, frames {k3.frames}, truncated_frames {k3.truncated_frames}")
    if not same or k3.launches != 1 or k3.frames != block.shape[0]:
        raise SystemExit("K3 disagrees with the host quad stage")

    def kernel():
        return board.quads(maskd)

    device_ms, eager_ms = graph_ms(kernel), cuda_ms(kernel)
    device_ms2, eager_ms2 = graph_ms(kernel), cuda_ms(kernel)
    w = maskd.shape[2]
    fetch_ms = host_ms(lambda: video._unpack_mask(packed.cpu().numpy(), w))
    quads_ms = host_ms(lambda: video._host_quads(mask_np, opts), reps=3)
    plain_ms = fetch_ms + quads_ms
    # Least time for the same work: the mask read once, the quads, their
    # validity and the counts written once.
    Fn, h, _ = maskd.shape
    Q = opts.max_quads
    nbytes = Fn * h * w + Fn * Q * (4 * 2 * 4 + 1) + Fn * 4
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    eager, device = min(eager_ms, eager_ms2), min(device_ms, device_ms2)
    log(f"[K3] {Fn}x{h}x{w}: kernel_ms={eager_ms:.4f},{eager_ms2:.4f} (per eager call; "
        f"{device_ms:.4f},{device_ms2:.4f} device, CUDA graph of 20 calls); host route "
        f"plain_ms={plain_ms:.2f} (mask fetch and unpack {fetch_ms:.2f}, labelling and fit "
        f"{quads_ms:.2f}, host clock); bound_ms={bound_ms:.5f} (bytes {nbytes / 1e6:.1f} MB); "
        f"share {100 * bound_ms / eager:.2f} % of the eager time, "
        f"{100 * bound_ms / device:.2f} % of the device time")
    return dict(name="quad_candidates_block", route="cuda", source=K3_SOURCE,
                replaces=K3_REPLACES, launches=0, max_abs_err=0.0, ms=eager, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None, ms_device=device,
                shape=[Fn, h, w], truncated_frames=k3.truncated_frames)


def k3_counts(quad_kernels):
    """K3's counters: (launches, frames, truncated_frames)."""
    k3 = quad_kernels.quad_candidates_block
    return k3.launches, k3.frames, k3.truncated_frames


def _timed(module, name, seconds):
    """Wrap ``module.name`` to add its wall seconds to ``seconds[name]``;
    returns the original."""
    real = getattr(module, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    setattr(module, name, wrapper)
    return real


def decoded_times(path, n):
    """Frame times (s) of an MP4 as cv2 decodes them, or None without cv2."""
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(path)
    out = []
    while len(out) < n + 1:
        ok, _ = cap.read()
        if not ok:
            break
        out.append(cap.get(cv2.CAP_PROP_POS_MSEC) * 1e-3)
    cap.release()
    return np.asarray(out)


def gopro_phase(torch, mods, tmp):
    """The GoPro MP4 path on the card (phase 10): render and mux the DS3
    recording, detect its frames on the card into a workspace, run the
    run_calibration CLI on the MP4's GPMF telemetry. Checks every bar;
    returns K2 block launches during detection, K1 launches by family
    during the CLI, K1's check per family, and K3's counters during
    detection."""
    recorded, mp4_writer, board_extractor, gpmf, run_cal, io, gram, kernels, quad_kernels, lie = \
        mods
    d, ws = os.path.join(tmp, "gopro"), os.path.join(tmp, "gopro_ws")
    os.makedirs(ws)
    kept, muxed, secs = [], [], {}
    real_render = recorded.render_frames

    def render_spy(*a, **kw):
        t0 = time.perf_counter()
        frames = real_render(*a, **kw)
        secs["render"] = secs.get("render", 0.0) + time.perf_counter() - t0
        kept.append((np.asarray(a[1], np.float64), frames))
        return frames

    real_payloads = mp4_writer.make_imu_payloads

    def payload_spy(times, accel, gyro, **kw):
        muxed.append((np.array(times), np.array(accel), np.array(gyro)))
        return real_payloads(times, accel, gyro, **kw)

    recorded.render_frames = render_spy
    mp4_writer.make_imu_payloads = payload_spy
    real_jpeg = _timed(mp4_writer, "encode_jpeg", secs)
    real_write = _timed(mp4_writer, "write_mp4", secs)
    try:
        t0 = time.perf_counter()
        rec = recorded.make_recording(d, **GOPRO, device="cuda")
        make_s = time.perf_counter() - t0
    finally:
        recorded.render_frames = real_render
        mp4_writer.make_imu_payloads = real_payloads
        mp4_writer.encode_jpeg, mp4_writer.write_mp4 = real_jpeg, real_write
    (_, frames_cam), (stamps_ic, frames_ic) = kept
    n_cam, n_ic = len(frames_cam), len(frames_ic)
    sizes = {k: os.path.getsize(v) for k, v in (("cam", rec.cam_video),
                                                 ("imu_cam", rec.imu_cam_video))}
    log(f"[gopro] make_recording {make_s:.2f} s: {n_cam} + {n_ic} frames 960x540 rendered in "
        f"{secs['render']:.2f} s ({1e3 * secs['render'] / (n_cam + n_ic):.2f} ms per frame), "
        f"JPEG encoding {secs['encode_jpeg']:.2f} s "
        f"({1e3 * secs['encode_jpeg'] / (n_cam + n_ic):.2f} ms per frame), muxing "
        f"{secs['write_mp4']:.2f} s; cam.MP4 {sizes['cam'] / 1e6:.1f} MB, imu_cam.MP4 "
        f"{sizes['imu_cam'] / 1e6:.1f} MB")

    # The times decoding gives: k / fps (a cv2 decode of a make_recording
    # MP4 returns CAP_PROP_POS_MSEC = 1000 k / fps).
    t_cam = np.arange(n_cam) / CAM_VIDEO_FPS
    t_ic = np.arange(n_ic) / GOPRO["cam_fps"]
    dec = decoded_times(rec.imu_cam_video, n_ic)
    if dec is None:
        log("[gopro] cv2 is not installed: the stamps k / fps are not checked against a decode")
        decode_ok = True
    else:
        decode_ok = len(dec) == n_ic and float(np.max(np.abs(dec - t_ic))) < 1e-9
        log(f"[gopro] cv2 decodes {len(dec)} frames of imu_cam.MP4, times within "
            f"{float(np.max(np.abs(dec[:n_ic] - t_ic[:len(dec)]))):.2e} s of k / fps")

    opts = board_extractor.BoardExtractorOptions(
        board_type="charuco", squares_x=GOPRO["squares_x"], squares_y=GOPRO["squares_y"],
        square_length=GOPRO["square_length"], marker_length=GOPRO["marker_length"],
        batch_frames=32)
    kernels.reset_counts()
    quad_kernels.reset_counts()
    t0 = time.perf_counter()
    ds_cam = board_extractor.extract_board(zip(t_cam, frames_cam), opts, device="cuda")
    ds_ic = board_extractor.extract_board(zip(t_ic, frames_ic), opts, device="cuda")
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    block_launches = kernels.corner_response_block.launches
    nms_launches = kernels.corner_response_nms.launches
    k3 = k3_counts(quad_kernels)
    del kept, frames_cam, frames_ic
    io.save_corners(ds_cam, os.path.join(ws, "cam_corners.uson"))
    io.save_corners(ds_ic, os.path.join(ws, "imu_cam_corners.uson"))
    per_frame = ds_ic.valid.sum(1)
    log(f"[gopro] extract_board {det_s:.2f} s for {n_cam + n_ic} frames "
        f"({1e3 * det_s / (n_cam + n_ic):.2f} ms per frame); imu-cam corners per frame: mean "
        f"{per_frame.mean():.2f}, >= 20 in {int((per_frame >= 20).sum())} of {n_ic} frames; "
        f"intrinsics video {int(ds_cam.valid.sum())} corners; corner_response_block launches "
        f"{block_launches}, corner_response_nms {nms_launches}; K3 launches {k3[0]}, frames "
        f"{k3[1]}, truncated_frames {k3[2]}")

    t0 = time.perf_counter()
    tel = gpmf.read_gopro_mp4(rec.imu_cam_video)
    read_s = time.perf_counter() - t0
    times, accel, gyro = muxed[0]
    gpmf_ok = (np.array_equal(tel.imu.accel, accel.astype(np.float32))
               and np.array_equal(tel.imu.gyro, gyro.astype(np.float32))
               and float(np.max(np.abs(tel.imu.times - times))) < 1e-9
               and len(tel.img_times) == n_ic
               and float(np.max(np.abs(tel.img_times - t_ic))) < 1e-9)
    log(f"[gopro] gpmf.read_gopro_mp4 {1e3 * read_s:.1f} ms: {len(tel.imu.times)} IMU samples, "
        f"{len(tel.img_times)} frame times, CORI {tel.cam_quats.shape}; equal to what was "
        f"muxed (float32 samples): {gpmf_ok}")

    gram_checked = {}
    real_gram = gram.fused_gram
    gram.reset_counts()
    kernels.reset_counts()
    gram.fused_gram = checking_gram_spy(gram, gram_checked)
    try:
        t0 = time.perf_counter()
        summary = run_cal.main([
            "--path_calib_dataset", d, "--telemetry_json", rec.imu_cam_video,
            "--telemetry_format", "gopro", "--num_squares_x", "10", "--num_squares_y", "8",
            "--checker_size_m", "0.04", "--marker_size_m", "0.03", "--workspace", ws,
            "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gram.fused_gram = real_gram
    counts = dict(gram.fused_gram.launches_by_tag)
    launches = gram.fused_gram.launches
    k2_cli = kernels.corner_response_block.launches + kernels.corner_response_nms.launches
    with open(os.path.join(ws, "imu_cam_result.json")) as f:
        n_lin = sum(s["linearizations"] for s in json.load(f)["lm_stages"])
    log(f"[gopro] run_calibration CLI wall {wall:.2f} s; stage_timings_s "
        f"{json.dumps(summary['stage_timings_s'])}; fused_gram launches {launches} ({counts}) "
        f"for {n_lin} linearizations; K2 launches during the CLI {k2_cli} (corners from the "
        f"workspace)")
    got = np.asarray(summary["intrinsics_params"])
    gt = rec.cam_params
    q = torch.tensor(summary["q_i_c"], dtype=torch.float64)
    rot_err = float(torch.linalg.vector_norm(lie.quat_boxminus(
        q, torch.as_tensor(rec.q_i_c, dtype=torch.float64))))
    dt_err = abs(summary["time_offset_s"] - rec.time_offset)
    ld = summary["line_delay_us"] * 1e-6
    t_err = np.abs(np.asarray(summary["t_i_c"]) - rec.t_i_c)
    g = np.asarray(summary["gravity"])
    measured = dict(intrinsics_reproj_px=summary["intrinsics_reproj_error_px"],
                    final_reproj_px=summary["final_reproj_error_px"],
                    time_offset_err_ms=dt_err * 1e3, line_delay_err_us=abs(ld - rec.line_delay)
                    * 1e6)
    log(f"[gopro] intrinsics {got.tolist()} (truth {gt.tolist()}); rotation error "
        f"{np.rad2deg(rot_err):.4f} deg, t_i_c error {t_err.tolist()} m, line delay "
        f"{ld * 1e6:.3f} us (truth {rec.line_delay * 1e6:.3f}), gravity {g.tolist()}")
    log("[gopro] accuracy, this run (unencoded frames) vs the JAX package's TPU v5e record "
        "(bench_cache/e2e_tpu.json, decoded JPEG; not a bar): " + ", ".join(
            f"{k} {measured[k]:.4f} vs {v}" for k, v in GOPRO_TPU.items()))
    numbers = [*measured.values(), *summary["t_i_c"], *summary["gravity"], *summary["q_i_c"],
               *got.tolist()]
    checks = {
        "frame stamps equal a cv2 decode of imu_cam.MP4 (where cv2 is installed)": decode_ok,
        "GPMF telemetry equals what was muxed": gpmf_ok,
        "intrinsics reprojection error < 0.31 px": measured["intrinsics_reproj_px"] < 0.31,
        "focal within 1%": abs(got[0] - gt[0]) / gt[0] < 0.01,
        "principal point within 2 px": abs(got[1] - gt[1]) < 2.0 and abs(got[2] - gt[2]) < 2.0,
        "|time offset - truth| < 3 ms": dt_err < 3e-3,
        "t_i_c within 5 mm per axis": bool(np.all(t_err < 5e-3)),
        "rotation within 0.5 deg": rot_err < np.deg2rad(0.5),
        "final reprojection error < 2.0 px": measured["final_reproj_px"] < 2.0,
        "|gravity| within 0.05 of 9.81 and g_z > 9.7":
            abs(np.linalg.norm(g) - 9.81) < 0.05 and g[2] > 9.7,
        "line delay within 30% of truth": abs(ld - rec.line_delay) < 0.3 * rec.line_delay,
        "finite result": all(math.isfinite(v) for v in numbers),
        "one K2 block launch per block of 32 frames": block_launches == math.ceil(n_cam / 32)
        + math.ceil(n_ic / 32) and nms_launches == 0,
        "one K3 launch per block of 32 frames": k3[:2] == (block_launches, 32 * block_launches),
        "3 kernel launches per linearization": n_lin > 0 and launches == 3 * n_lin and all(
            counts.get(f, 0) == n_lin for f in ("obs", "accel", "gyro")),
        "fused_gram held against its plain version at each family's shapes":
            sorted(gram_checked) == ["accel", "gyro", "obs"],
    }
    for k, ok in checks.items():
        log(f"[gopro] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("gopro path checks failed")
    shutil.rmtree(d, ignore_errors=True)
    return block_launches, counts, gram_checked, k3


def static_imu_phase(torch, mods, tmp):
    """The static-imu-calibration tool on the card (phase 11), its json read
    back and held to tests/test_static_imu.py's bars; the gyro LM timed,
    and its CUDA launches counted."""
    misc_tools, static_imu_calibrator, telemetry, io, synthetic = mods
    tr = synthetic.MULTIPOSE_TRUTH
    imu = synthetic.make_multipose_imu(np.random.default_rng(42))
    tel_path, out = os.path.join(tmp, "multipose.json"), os.path.join(tmp, "imu_intr.json")
    telemetry.write_generic_json(telemetry.CameraTelemetry(imu=imu), tel_path)
    t0 = time.perf_counter()
    info = misc_tools.static_imu_main(["--telemetry_json", tel_path, "--output_path", out,
                                       "--initial_static_duration_s", "5.0",
                                       "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc, gyr = io.load_imu_intrinsics(out)

    # One linearization and one cost evaluation of the gyro fit on the same
    # intervals, timed and under the profiler: their CUDA kernel launches.
    from torch.profiler import ProfilerActivity, profile
    lin, cost, _, params0, _, _ = static_imu_calibrator.gyro_problem(
        telemetry.read_generic_json(tel_path).imu, info["intervals"], acc, 9.81, "cuda")
    lin_ms, cost_ms = cuda_ms(lambda: lin(params0), 0, 1), cuda_ms(lambda: cost(params0), 0, 1)
    launches = {}
    for name, fn in (("linearization", lin), ("cost evaluation", cost)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(params0)
            torch.cuda.synchronize()
        # The raw device activities (building the profiler's event tree
        # for ~10^5 of them would take minutes), copies and fills left out.
        launches[name] = sum(1 for e in prof.profiler.kineto_results.events()
                             if e.device_type() == torch.autograd.DeviceType.CUDA
                             and not e.name().startswith(("Memcpy", "Memset")))
    log(f"[static imu] static-imu-calibration tool {wall:.2f} s on {len(imu.times)} samples: "
        f"{info['num_intervals']} static intervals (threshold x{info['threshold_mult']}); gyro "
        f"LM {info['gyro_seconds']:.2f} s, {info['gyro_iterations']} iterations, "
        f"{info['gyro_linearizations']} linearizations; one linearization {lin_ms:.1f} ms with "
        f"{launches['linearization']} CUDA kernel launches, one cost evaluation {cost_ms:.1f} ms "
        f"with {launches['cost evaluation']} (torch.profiler)")
    log(f"[static imu] accel scale {acc.scale.tolist()} bias {acc.bias.tolist()}; gyro scale "
        f"{gyr.scale.tolist()} bias {gyr.bias.tolist()}")
    cal = acc.unbias_normalize(imu.accel[:400])
    checks = {
        ">= 12 static intervals": info["num_intervals"] >= 12,
        "accel scale within 5e-3": np.allclose(acc.scale, tr["accel_scale"], rtol=0, atol=5e-3),
        "accel bias within 2e-2": np.allclose(acc.bias, tr["accel_bias"], rtol=0, atol=2e-2),
        "accel misalignment within 5e-3":
            np.allclose(acc.misalignment, tr["accel_misalignment"], rtol=0, atol=5e-3),
        "gyro scale within 1e-2": np.allclose(gyr.scale, tr["gyro_scale"], rtol=0, atol=1e-2),
        "gyro bias within 2e-3": np.allclose(gyr.bias, tr["gyro_bias"], rtol=0, atol=2e-3),
        "gyro misalignment within 1e-2":
            np.allclose(gyr.misalignment, tr["gyro_misalignment"], rtol=0, atol=1e-2),
        "calibrated static accel norm within 0.02 of g":
            abs(np.linalg.norm(cal, axis=1).mean() - 9.81) < 0.02,
        "the profiler saw the gyro fit's kernels": min(launches.values()) > 0,
    }
    for k, ok in checks.items():
        log(f"[static imu] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("static IMU checks failed")


def ds3_problem(duration, device, seed=7, perturb=False):
    """The DS3 recording cut to ``duration`` seconds (scene ``seed``), as a
    spline problem on ``device`` with its truth-seeded initial point:
    (problem, params, scene). No files: what scripts/sweep_torch_banded.py
    times the solves on. ``perturb`` starts away from the truth instead:
    T_imu_cam rotated by ~17 mrad and moved by 10 mm per axis, the clock
    offset INIT_TIME_ERR off (the problem is built on it, so the solve's
    offset is the final offset's error from it) and the line delay at one
    frame time over 540 rows (bench.py's start)."""
    import torch

    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.models import cameras
    from openimucameracalibrator_torch.ops import lie
    from openimucameracalibrator_torch.utils import synthetic
    from openimucameracalibrator_torch.utils.types import (CameraCalibration, CornerDataset,
                                                           ImuData, PoseDataset,
                                                           SplineWeightingData)

    sc = synthetic.make_imu_camera_scene(
        cameras.get_model("division_undistortion"), CAM, duration=duration, cam_fps=CAM_FPS,
        imu_rate=IMU_RATE, time_offset=TIME_OFFSET, line_delay=LINE_DELAY, seed=seed,
        device=device)
    corners = CornerDataset(sc.frame_times, sc.observations, sc.obs_valid, sc.board.points,
                            sc.image_size, CAM_FPS)
    imu = ImuData(sc.imu_times, sc.accel, sc.gyro)
    offset = TIME_OFFSET + (INIT_TIME_ERR if perturb else 0.0)
    p = se.build_problem(corners, CameraCalibration(sc.model.name, sc.cam_params,
                                                    sc.image_size, 0.0), imu,
                         SplineWeightingData(cam_fps=CAM_FPS, **SEW), offset,
                         rolling_shutter=True, device=device)
    poses = PoseDataset(sc.frame_times, sc.q_w_c, sc.t_w_c, np.ones(len(sc.frame_times), bool),
                        sc.board.points)
    q_i_c, t_i_c, ld = sc.q_i_c, sc.t_i_c, LINE_DELAY
    if perturb:
        q_i_c = lie.quat_boxplus(torch.as_tensor(np.asarray(sc.q_i_c), dtype=torch.float64),
                                 torch.tensor([0.01, -0.01, 0.01], dtype=torch.float64)).numpy()
        t_i_c, ld = np.asarray(sc.t_i_c) + 0.01, 1.0 / CAM_FPS / 540
    params = se.init_spline_params(poses, q_i_c, t_i_c, p, imu, pose_time_offset=offset,
                                   device=device)
    params["line_delay"] = torch.tensor([ld], dtype=params["line_delay"].dtype, device=device)
    return p, params, sc


def stage8_setup(torch, device, tmp, duration=DURATION):
    """The DS3-scale scene (``duration`` seconds) on the card, its stage-8
    artifacts in ``tmp``, the spline problem, its chunk plan, and the fast
    linearizer with the problem's initial point (``lin(params0)`` hands K1
    the main path's inputs)."""
    import types

    from openimucameracalibrator_torch.apps.estimate_imu_to_camera_rotation import \
        load_imu_camera_init
    from openimucameracalibrator_torch.apps.estimate_poses import load_pose_dataset
    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.models import cameras
    from openimucameracalibrator_torch.utils import io, synthetic
    from openimucameracalibrator_torch.utils.types import ImuData, SplineWeightingData

    t0 = time.perf_counter()
    scene = synthetic.make_imu_camera_scene(
        cameras.get_model("division_undistortion"), CAM, duration=duration,
        cam_fps=CAM_FPS, imu_rate=IMU_RATE, image_size=(960, 540), noise_px=0.2,
        time_offset=TIME_OFFSET, line_delay=LINE_DELAY, seed=7, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    paths = synthetic.write_stage8_inputs(scene, tmp, cam_fps=CAM_FPS, **SEW,
                                          init_rot_err=INIT_ROT_ERR,
                                          init_time_err=INIT_TIME_ERR)
    corners = io.load_corners(paths["input_corners"])
    log(f"[scene] {duration:.0f} s: {len(scene.frame_times)} views, "
        f"{int(scene.obs_valid.sum())} valid of "
        f"{scene.obs_valid.size} observations, {len(scene.imu_times)} IMU samples; "
        f"rendered in {t1 - t0:.2f} s, artifacts written in {time.perf_counter() - t1:.2f} s")
    imu = ImuData(times=scene.imu_times, accel=scene.accel, gyro=scene.gyro)
    sew = SplineWeightingData(cam_fps=CAM_FPS, **SEW)
    problem = se.build_problem(corners, io.load_camera_calibration(
        paths["camera_calibration_json"]), imu, sew, TIME_OFFSET + INIT_TIME_ERR,
        rolling_shutter=True, device=device)
    shapes, D = family_shapes(se, problem)
    log(f"[scene] tangent dim D={D}; chunk plan: " + "; ".join(
        f"{n} K={K} R={R} F={F} L={L}" for n, K, R, _, F, _, L in shapes))

    # The linearizer at the problem's initial point: K1's main-path inputs.
    init = load_imu_camera_init(paths["imu_rotation_init"])
    qg = init.q_gyro_to_cam
    params0 = se.init_spline_params(
        load_pose_dataset(paths["input_pose_dataset"]), [qg[0], -qg[1], -qg[2], -qg[3]],
        [0.0, 0.0, 0.0],
        problem, imu, pose_time_offset=init.time_offset, device=device)
    params0["line_delay"] = torch.tensor([1.0 / CAM_FPS / 540], device=device)
    lin, _ = se.make_solver_functions_fast(problem, se.build_layout(problem))
    return types.SimpleNamespace(scene=scene, paths=paths, imu=imu, problem=problem,
                                 shapes=shapes, D=D, params0=params0, lin=lin)


def stage8_bars(se, lie, torch, p, prm, scene):
    """The main phase's stage-8 bars for one solved sequence built by
    ds3_problem(perturb=True): {name: (ok, value)}."""
    rot = float(torch.linalg.vector_norm(lie.quat_boxminus(
        prm["q_i_c"].double().cpu(), torch.as_tensor(np.asarray(scene.q_i_c), dtype=torch.float64))))
    dt = abs(TIME_OFFSET + INIT_TIME_ERR + float(prm["time_offset"][0]) - TIME_OFFSET)
    ld = float(prm["line_delay"][0])
    t_err = float(np.max(np.abs(prm["t_i_c"].double().cpu().numpy() - np.asarray(scene.t_i_c))))
    reproj = se.mean_reprojection_error(p, prm)
    return {"rotation error < 0.01 rad": (rot < 0.01, rot),
            "|time offset - truth| < 2 ms": (dt < 2e-3, dt),
            "line delay within 30% of truth": (abs(ld - LINE_DELAY) < 0.3 * LINE_DELAY, ld),
            "t_i_c within 20 mm per axis": (t_err < 0.02, t_err),
            "mean reprojection error < 0.35 px": (reproj < 0.35 and math.isfinite(reproj),
                                                  reproj)}


def gram_row(gram, name, J, r, idx, segs, L, launches):
    """K1 checked and timed on one captured input (time_gram), with its
    bound: a row of the kernels line."""
    K, R, F = J.shape
    err = check_gram(gram, name, J, r, idx, segs, L)
    device_ms, kernel_ms, plain_ms, library_ms = time_gram(gram, J, r, idx, segs, L)
    bound_ms, t_bytes, t_ops, nbytes, ops = gram_bound(K, R, F, L, idx.shape[0])
    log(f"kernel[{name}] K={K} R={R} F={F} L={L}: kernel_ms={kernel_ms:.4f} (per eager call; "
        f"{device_ms:.4f} device) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.5f} ({'bytes' if t_bytes >= t_ops else 'operations'}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP; share {100 * bound_ms / device_ms:.2f} % "
        f"of the device time)")
    return dict(name=f"fused_gram[{name}]", route="cuda", source=SOURCE, replaces=REPLACES,
                launches=launches, max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms, ms_device=device_ms, shape=dict(K=K, R=R, F=F, L=int(L)))


def _counted(gram, checked, label, fn):
    """fn() with K1's launches counted from 0 and each family's first launch
    held against its plain version: (result, wall s, launches by family)."""
    real = gram.fused_gram
    gram.reset_counts()
    gram.fused_gram = checking_gram_spy(gram, checked, label)
    try:
        t0 = time.perf_counter()
        out = fn()
        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gram.fused_gram = real
    return out, wall, dict(gram.fused_gram.launches_by_tag)


def batch_phase(torch, mods):
    """Multi-sequence batch calibration on the card (phase 12): N=4 DS3-scale
    sequences (bench.py's measure_batch), both modes, the batched
    linearizer's time and memory against single-sequence ones, its
    sequential mode, and K1 at the batched shapes. Returns K1 rows at the
    batched shapes and the launches by family of each mode."""
    se, be, lm, gram, lie = mods
    t0 = time.perf_counter()
    built = [ds3_problem(d, "cuda", seed=s, perturb=True)
             for d, s in zip(BATCH_DURATIONS, BATCH_SEEDS)]
    problems, inits, scenes = (list(x) for x in zip(*built))
    torch.cuda.synchronize()
    log(f"[batch] {len(problems)} DS3 sequences ({', '.join(f'{d:.0f} s' for d in BATCH_DURATIONS)}"
        f", seeds {BATCH_SEEDS}) built in {time.perf_counter() - t0:.2f} s; tangent dims "
        f"{[se.build_layout(p).tangent_dim for p in problems]}")
    batch = be.build_sequence_batch(problems, **BATCH_CHUNKS)
    layout = se.build_layout(batch.p_ref)
    shapes = se.gram_layouts(batch.p_ref, batch.plans)
    max_f, max_run = gram.build().lib.oicc_gram_max_f(), gram.build().lib.oicc_gram_max_run()
    for (name, (rd, F, segs, L)), plan in zip(shapes.items(), batch.plans):
        n_run = sum(1 for sg in segs if sg[0] == "run")
        log(f"[batch] {name}: common plan K={plan.n_chunks} per sequence ({batch.n_seq * plan.n_chunks}"
            f" in one launch), chunk {plan.chunk}, w_s={plan.w_s} w_r={plan.w_r}, L={L}, F={F}, "
            f"runs={n_run} (K1 limits: F <= {max_f}, runs <= {max_run})")
        if F > max_f or n_run > max_run:
            raise SystemExit(f"batched {name} family is outside K1's limits")
    params_b = be.stack_params(batch, inits)
    lin_b = be.make_batch_linearizer(batch, layout)

    # Time and memory: one batched linearization against the four single ones.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms_b = cuda_ms(lambda: lin_b(params_b), warm=2, reps=5)
    peak_b = torch.cuda.max_memory_allocated()
    ms_1 = []
    for p, prm in zip(problems, inits):
        lin1, _ = se.make_solver_functions_fast(p, se.build_layout(p), **BATCH_CHUNKS)
        ms_1.append(cuda_ms(lambda: lin1(prm), warm=2, reps=5))
    torch.cuda.empty_cache()
    lin_s = be.make_batch_linearizer(batch, layout, sequential=True)
    Hb, gb, cb = lin_b(params_b)
    lin_s(params_b)  # builds its per-chunk index tables
    torch.cuda.reset_peak_memory_stats()
    gram.reset_counts()
    out = []  # one call (one launch per chunk and family, ~10 s), timed with CUDA events
    ms_s = cuda_ms(lambda: out.append(lin_s(params_b)), warm=0, reps=1)
    Hs, gs, cs = out.pop()
    seq_counts = dict(gram.fused_gram.launches_by_tag)
    peak_s = torch.cuda.max_memory_allocated()
    seq_err = dict(H=((Hs - Hb).abs().max() / Hb.abs().max()).item(),
                   g=((gs - gb).abs().max() / gb.abs().max()).item(),
                   cost=((cs - cb).abs().max() / cb.abs().max()).item())
    want_seq = {"obs": batch.plans[0].n_chunks, "accel": batch.plans[1].n_chunks,
                "gyro": batch.plans[2].n_chunks}
    del Hs, gs, Hb, gb
    log(f"[batch] linearize N=4 batched {ms_b:.2f} ms vs single {[round(m, 2) for m in ms_1]} "
        f"ms (sum {sum(ms_1):.2f}, 4x mean {4 * np.mean(ms_1):.2f}); ratio batched / sum "
        f"{ms_b / sum(ms_1):.3f}; peak memory {peak_b / 2**20:.0f} MiB (CUDA events)")
    log(f"[batch] sequential mode: {ms_s:.2f} ms, peak memory {peak_s / 2**20:.0f} MiB, K1 "
        f"launches {seq_counts} (one per chunk: {want_seq}); against the batched mode H rel "
        f"{seq_err['H']:.2e}, g rel {seq_err['g']:.2e}, cost rel {seq_err['cost']:.2e}")

    # K1 at the batched shapes, on the linearizer's own inputs.
    captured = capture_linearizer_inputs(gram, lin_b, params_b)
    rows = {}
    for name, (rd, F, segs, L) in shapes.items():
        J, r, idx = captured[name]
        rows[name] = gram_row(gram, f"{name}, batch N={batch.n_seq}", J, r, idx, segs, L, 0)
    del captured
    torch.cuda.empty_cache()

    flags = se.DEFAULT_FLAGS | {se.CAM_LINE_DELAY, se.TIME_OFFSET}
    cfg = lm.LMConfig(max_iters=30, ftol=1e-4)
    checks, counts, checked = {}, {}, {}
    for mode in ("independent", "joint"):
        checked[mode] = {}
        torch.cuda.reset_peak_memory_stats()
        res, wall, counts[mode] = _counted(gram, checked[mode], f"batch {mode}", lambda: (
            be.optimize_batch(problems, inits, flags=flags, config=cfg, mode=mode,
                              **BATCH_CHUNKS)))
        n_lin = res.linearizations
        its = (res.iterations.tolist() if torch.is_tensor(res.iterations) else res.iterations)
        log(f"[batch] {mode}: wall {wall:.2f} s, LM iterations {its}, {n_lin} batched "
            f"linearizations, loop {res.seconds:.2f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, K1 launches {counts[mode]}")
        checks[f"{mode}: 3 K1 launches per batched linearization"] = n_lin > 0 and all(
            counts[mode].get(f, 0) == n_lin for f in ("obs", "accel", "gyro")) and sum(
            counts[mode].values()) == 3 * n_lin
        checks[f"{mode}: K1 held against its plain version at each family's batched shapes"] = \
            sorted(checked[mode]) == ["accel", "gyro", "obs"]
        for i, (p, prm, sc) in enumerate(zip(problems, res.params, scenes)):
            bars = stage8_bars(se, lie, torch, p, prm, sc)
            log(f"[batch] {mode} sequence {i}: " + ", ".join(
                f"{k.split(' ')[0]} {v:.4g}" for k, (_, v) in bars.items()))
            for k, (ok, _) in bars.items():
                checks[f"{mode} sequence {i}: {k}"] = ok
        if mode == "independent":
            t0 = time.perf_counter()
            ref = se.optimize(problems[0], inits[0], flags, config=cfg, method="fast")
            torch.cuda.synchronize()
            c_b, c_1 = float(res.cost[0]), float(ref.cost)
            log(f"[batch] sequence 0 alone: {ref.iterations} iterations, cost {c_1:.6e} "
                f"(batched {c_b:.6e}, {int(res.iterations[0])} iterations), "
                f"{time.perf_counter() - t0:.2f} s")
            checks["independent sequence 0: cost within 1e-3 of its single solve"] = \
                abs(c_b - c_1) <= 1e-3 * abs(c_1)
            checks["independent sequence 0: the single solve's iteration count"] = \
                int(res.iterations[0]) == ref.iterations
        else:
            checks["joint: the shared blocks are identical across sequences"] = all(
                torch.equal(res.params[i][k], res.params[0][k])
                for k in be.DEFAULT_SHARED for i in range(1, len(problems)))
    checks["sequential mode: one K1 launch per chunk and family"] = seq_counts == want_seq
    checks["sequential mode: H, g and cost equal the batched mode (rel 1e-5)"] = all(
        v < 1e-5 for v in seq_err.values())
    for k, ok in checks.items():
        log(f"[batch] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("batch checks failed")
    for name, row in rows.items():
        row["launches"] = counts["independent"].get(name, 0)
        row["launches_joint"] = counts["joint"].get(name, 0)
        row["max_abs_err_batch"] = max(checked[m][name]["max_abs_err"] for m in checked)
    return rows, counts


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def sharded_phase(torch, mods):
    """The data-parallel and knot-sharded Schur solvers on the card (phase
    13): n=4 shards in one process against the single-device linearizer
    and solve, then the process-group layout (world size 1 on NCCL, and two
    ranks on the card over gloo in subprocesses). Returns K1 launches by
    family of each solve."""
    se, sharded, schur, multihost, lm, gram = mods
    import torch.distributed as dist

    p, params, _ = ds3_problem(DURATION, "cuda", seed=7, perturb=True)
    layout = se.build_layout(p)
    lin1, _ = se.make_solver_functions_fast(p, layout)
    H0, g0, c0 = lin1(params)
    mesh = sharded.make_mesh(SHARDS, device="cuda")
    lin_sh, cost_sh, _ = sharded.make_sharded_fast_solver_functions(p, mesh, **SHARD_CHUNKS)
    gram.reset_counts()
    H1, g1, c1 = lin_sh(params)
    torch.cuda.synchronize()
    lin_counts = dict(gram.fused_gram.launches_by_tag)
    err = dict(H=((H1 - H0).abs().max() / H0.abs().max()).item(),
               g=((g1 - g0).abs().max() / g0.abs().max()).item(),
               cost=abs(float(c1) - float(c0)) / abs(float(c0)))
    ms_sh = cuda_ms(lambda: lin_sh(params), warm=1, reps=3)
    ms_1 = cuda_ms(lambda: lin1(params), warm=1, reps=3)
    del H1, g1, H0, g0
    log(f"[sharded] {SHARDS} shards: H rel {err['H']:.2e}, g rel {err['g']:.2e}, cost rel "
        f"{err['cost']:.2e} against the single-device linearizer; K1 launches {lin_counts}; "
        f"linearize {ms_sh:.2f} ms (single device {ms_1:.2f} ms)")
    flags = se.DEFAULT_FLAGS | {se.CAM_LINE_DELAY, se.TIME_OFFSET}
    cfg = lm.LMConfig(max_iters=3, ftol=0.0)
    t0 = time.perf_counter()
    ref = se.optimize(p, params, flags, config=cfg, method="fast")
    torch.cuda.synchronize()
    log(f"[sharded] single-device solve: {ref.iterations} iterations, cost "
        f"{float(ref.cost):.6e}, {time.perf_counter() - t0:.2f} s")
    results, counts = {}, {}
    for name, run in (("sharded", sharded.optimize_sharded), ("schur", schur.optimize_schur)):
        checked = {}
        res, wall, counts[name] = _counted(gram, checked, name, lambda: run(
            p, params, mesh, flags, config=cfg, **SHARD_CHUNKS))
        results[name] = (res, wall)
        log(f"[sharded] {name} x{SHARDS}: {res.iterations} iterations, cost "
            f"{float(res.cost):.6e}, wall {wall:.2f} s, K1 launches {counts[name]} for "
            f"{res.linearizations} linearizations")
    _, _, _, _, part = schur.make_schur_solver_functions(p, mesh, **SHARD_CHUNKS)
    log(f"[sharded] schur partition: D={layout.tangent_dim}, local m={part.m}, separator "
        f"S={part.S}")

    # The process-group layout: world size 1 on NCCL in this process.
    assert multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda", timeout_s=120)
    backend = dist.get_backend()
    try:
        mesh1 = multihost.global_mesh()
        t0 = time.perf_counter()
        res_pg = sharded.optimize_sharded(p, params, mesh1, flags, config=cfg, **SHARD_CHUNKS)
        torch.cuda.synchronize()
        pg_wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    log(f"[sharded] process group ({backend}, world size 1): {res_pg.iterations} iterations, "
        f"cost {float(res_pg.cost):.6e}, wall {pg_wall:.2f} s")

    # Two ranks on the card (gloo with CUDA tensors), each loading only
    # its time slice, in subprocesses with a time limit.
    port = _free_port()
    env = dict(os.environ)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker",
                               str(r), "2", str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    outs = []
    t0 = time.perf_counter()
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        raise SystemExit(f"a rank did not finish within {RANK_TIMEOUT_S} s")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    ranks = []
    for r, (pr, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        if pr.returncode != 0 or not lines:
            raise SystemExit(f"rank {r} failed (exit {pr.returncode}):\n{out[-4000:]}")
        ranks.append(json.loads(lines[-1][5:]))
    log(f"[sharded] 2 ranks on one card over gloo: {ranks} ({time.perf_counter() - t0:.2f} s "
        "with start-up)")

    c_ref = float(ref.cost)
    checks = {
        f"{SHARDS} shards: H and g within 1e-4 of the single-device linearizer's (relative "
        "to the largest entry), cost within 1e-5": err["H"] < 1e-4 and err["g"] < 1e-4
        and err["cost"] < 1e-5,
        "3 K1 launches per shard and linearization": all(
            lin_counts.get(f, 0) == SHARDS for f in ("obs", "accel", "gyro")),
        "world size 1 on NCCL": backend == "nccl",
        "two ranks computed the same solution": ranks[0]["cost"] == ranks[1]["cost"]
        and ranks[0]["iterations"] == ranks[1]["iterations"],
        "each rank held only its time slice": all(r["obs_rows"] < r["obs_rows_full"]
                                                  for r in ranks),
    }
    for name, (res, _) in list(results.items()) + [("process group", (res_pg, 0)),
                                                  ("2 ranks", (None, 0))]:
        c = ranks[0]["cost"] if res is None else float(res.cost)
        it = ranks[0]["iterations"] if res is None else res.iterations
        checks[f"{name}: cost within 1e-3 of the single-device solve, same iterations"] = (
            math.isfinite(c) and abs(c - c_ref) <= 1e-3 * abs(c_ref) and it == ref.iterations)
    for name in ("sharded", "schur"):
        n_lin = results[name][0].linearizations
        checks[f"{name}: 3 K1 launches per shard and linearization"] = all(
            counts[name].get(f, 0) == SHARDS * n_lin for f in ("obs", "accel", "gyro"))
    for k, ok in checks.items():
        log(f"[sharded] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("sharded / schur checks failed")
    return counts


def rank_worker(rank, world, port):
    """One rank of the sharded phase's 2-rank run (chip_smoke.py
    --rank-worker RANK WORLD PORT): joins a gloo group on the card, loads
    only its time slice of the DS3 problem and runs the sharded LM."""
    import torch
    import torch.distributed as dist

    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.parallel import multihost, sharded
    from openimucameracalibrator_torch.solver import lm

    assert multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                device="cuda", timeout_s=RANK_TIMEOUT_S)
    p_full, params, _ = ds3_problem(DURATION, "cuda", seed=7, perturb=True)
    t_lo = float(min(p_full.accel_t.min(), p_full.obs_t.min()))
    t_hi = float(max(p_full.accel_t.max(), p_full.obs_t.max())) + 1e-6
    lo, hi = multihost.host_time_range(t_lo, t_hi)
    local = {}
    for fam, tkey in (("accel", "accel_t"), ("gyro", "gyro_t"), ("obs", "obs_t")):
        m = multihost.host_shard(getattr(p_full, tkey).cpu().numpy(), lo, hi)
        for f in se.SplineProblem._fields:
            v = getattr(p_full, f)
            if f.startswith(fam) and isinstance(v, torch.Tensor):
                local[f] = v.cpu().numpy()[m]
    meta = {f: getattr(p_full, f) for f in
            ("t0", "dt_so3", "dt_r3", "dt_bias", "n_so3", "n_r3", "n_bias", "w_accel",
             "w_gyro", "cam_params", "model_name", "rolling_shutter")}
    rows = multihost.agree_per_host_rows(local)
    mesh = multihost.global_mesh()
    p_loc = multihost.make_global_problem(local, meta, mesh, per_host_rows=rows)
    obs_full = int(p_full.obs_valid.sum())
    del p_full
    flags = se.DEFAULT_FLAGS | {se.CAM_LINE_DELAY, se.TIME_OFFSET}
    t0 = time.perf_counter()
    res = sharded.optimize_sharded(p_loc, params, mesh, flags,
                                   config=lm.LMConfig(max_iters=3, ftol=0.0), **SHARD_CHUNKS)
    torch.cuda.synchronize()
    print("RANK " + json.dumps(dict(
        rank=rank, cost=float(res.cost), iterations=res.iterations,
        wall_s=round(time.perf_counter() - t0, 3), obs_rows=int(p_loc.obs_valid.sum()),
        obs_rows_full=obs_full,
        device=str(mesh.device))), flush=True)
    dist.destroy_process_group()
    return 0


def batch_cli_phase(torch, mods, tmp):
    """The batch CLI on the card at a small depth (phase 14): two short
    make_recording captures (tests/test_batch_cli.py's settings) rendered on
    the card, their frames fed to the detectors as phase 10 feeds them,
    intrinsics from the first recording's intrinsics video, then
    ``batch_calibration --mode joint``, held to that test's bars. Returns
    the K2 launches (block, frame), the K1 launches by family and K3's
    counters."""
    (recorded, board_extractor, camera_calibrator, io, batch_cli, kernels, quad_kernels, gram,
     lie) = mods
    frames_of, recs = {}, []
    real_render = recorded.render_frames
    for i, seed in enumerate(BATCH_CLI_SEEDS):
        kept = []

        def render_spy(*a, **kw):
            frames = real_render(*a, **kw)
            kept.append(frames)
            return frames

        recorded.render_frames = render_spy
        try:
            rec = recorded.make_recording(os.path.join(tmp, f"batch_r{i}"), seed=seed,
                                          device="cuda", **BATCH_CLI)
        finally:
            recorded.render_frames = real_render
        fc, fi = kept
        frames_of[rec.cam_video] = (np.arange(len(fc)) / CAM_VIDEO_FPS, fc)
        frames_of[rec.imu_cam_video] = (np.arange(len(fi)) / BATCH_CLI["cam_fps"], fi)
        recs.append(rec)
    opts = board_extractor.BoardExtractorOptions(
        squares_x=BATCH_CLI["squares_x"], squares_y=BATCH_CLI["squares_y"],
        square_length=BATCH_CLI["square_length"], marker_length=BATCH_CLI["marker_length"])
    ds = board_extractor.extract_board(zip(*frames_of[recs[0].cam_video]), opts, device="cuda")
    calib, _ = camera_calibrator.calibrate_camera(ds, "division_undistortion", device="cuda")
    calib_path = os.path.join(tmp, "batch_cam_calib.json")
    io.save_camera_calibration(calib, calib_path)
    log(f"[batch cli] 2 recordings rendered; intrinsics from {len(frames_of[recs[0].cam_video][1])}"
        f" frames: reprojection {calib.mean_reproj_error:.4f} px")

    real_extract = board_extractor.extract_board_from_video

    def from_frames(video, o, device=None):
        return board_extractor.extract_board(zip(*frames_of[video]), o, device=device)

    board_extractor.extract_board_from_video = from_frames
    kernels.reset_counts()
    quad_kernels.reset_counts()
    out_path = os.path.join(tmp, "batch_rig.json")
    try:
        out, wall, k1 = _counted(gram, {}, "batch CLI", lambda: batch_cli.main(
            sum([["--recording", r.imu_cam_video] for r in recs], []) + [
                "--camera_calibration_json", calib_path, "--telemetry_format", "gopro",
                "--num_squares_x", str(BATCH_CLI["squares_x"]),
                "--num_squares_y", str(BATCH_CLI["squares_y"]),
                "--checker_size_m", str(BATCH_CLI["square_length"]),
                "--marker_size_m", str(BATCH_CLI["marker_length"]), "--global_shutter",
                "--max_iters", "25", "--mode", "joint", "--output_json", out_path,
                "--device", "cuda"]))
    finally:
        board_extractor.extract_board_from_video = real_extract
    k2 = (kernels.corner_response_block.launches, kernels.corner_response_nms.launches)
    k3 = k3_counts(quad_kernels)
    q = np.asarray(out["q_i_c"])
    ang = 2 * np.arccos(min(1.0, abs(float(np.dot(q, np.asarray(recs[0].q_i_c))))))
    t_err = float(np.max(np.abs(np.asarray(out["t_i_c"]) - np.asarray(recs[0].t_i_c))))
    log(f"[batch cli] joint CLI wall {wall:.2f} s: rotation error {np.rad2deg(ang):.4f} deg, "
        f"t_i_c error {t_err * 1e3:.2f} mm, sequences "
        f"{[(round(sq['mean_reproj_error_px'], 4), round(sq['time_offset_s'], 5)) for sq in out['sequences']]}; "
        f"K2 launches (block, frame) {k2}, K1 launches {k1}; K3 launches {k3[0]}, frames "
        f"{k3[1]}, truncated_frames {k3[2]}")
    checks = {
        "two sequences, joint mode": out["n_sequences"] == 2 and out["mode"] == "joint",
        "rotation within 1 deg": ang < np.deg2rad(1.0),
        "t_i_c within 20 mm per axis": t_err < 0.02,
        "mean reprojection error < 2 px per sequence": all(
            sq["mean_reproj_error_px"] < 2.0 for sq in out["sequences"]),
        "|time offset - truth| < 5 ms per sequence": all(
            abs(sq["time_offset_s"] - recs[0].time_offset) < 5e-3 for sq in out["sequences"]),
        "K2 ran on the card": sum(k2) > 0,
        "one K3 launch per K2 block launch, 32 frames each":
            k2[0] > 0 and k3[:2] == (k2[0], 32 * k2[0]),
        "K1 ran on the card": all(k1.get(f, 0) > 0 for f in ("obs", "accel", "gyro")),
    }
    for k, ok in checks.items():
        log(f"[batch cli] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("batch CLI checks failed")
    return k2, k1, k3


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "openimucameracalibrator_torch")):
        print("chip_smoke: the openimucameracalibrator_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from openimucameracalibrator_torch.apps import batch_calibration as batch_cli
    from openimucameracalibrator_torch.apps import calibrate_camera as cal_cli
    from openimucameracalibrator_torch.apps import continuous_time_calibration as cli
    from openimucameracalibrator_torch.apps import misc_tools
    from openimucameracalibrator_torch.apps import run_calibration as run_cal
    from openimucameracalibrator_torch.core import (batch_estimator, board_extractor,
                                                    camera_calibrator, gpmf, imu_cam_rotation,
                                                    imu_camera_calibrator, pose_estimator,
                                                    static_imu_calibrator, telemetry)
    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.detect import (checkerboard, kernels, quad_kernels,
                                                      render, video)
    from openimucameracalibrator_torch.models import cameras
    from openimucameracalibrator_torch.ops import lie
    from openimucameracalibrator_torch.parallel import multihost, schur, sharded
    from openimucameracalibrator_torch.solver import banded, gram, lm
    from openimucameracalibrator_torch.utils import io, mp4_writer, precision, recorded, synthetic

    t_start = time.perf_counter()
    device = precision.resolve_device("cuda")  # also turns TF32 off
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    build_kernels(gram.build, kernels.build, quad_kernels.build, gpmf.library)
    tmp = tempfile.mkdtemp(prefix="oicc_chip_smoke_")
    st = stage8_setup(torch, device, tmp)
    scene, paths, shapes, D = st.scene, st.paths, st.shapes, st.D
    lin, params0 = st.lin, st.params0
    captured = capture_linearizer_inputs(gram, lin, params0)

    rows = kernel_phase(gram, shapes, captured)
    del captured

    out = os.path.join(tmp, "result.json")
    argv = sum([[f"--{k}", v] for k, v in paths.items()], [])
    argv += ["--output_path", out, "--device", "cuda"]
    gram.reset_counts()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(gram.fused_gram.launches_by_tag)
    launches = gram.fused_gram.launches
    res = io.load_imu_camera_result(out)
    stages = res["lm_stages"]
    n_lin = sum(s["linearizations"] for s in stages)
    for i, s in enumerate(stages):
        log(f"[main] LM stage {i}: {s['iterations']} iterations, {s['status']}, "
            f"{s['seconds']:.3f} s wall, {s['linearizations']} linearizations "
            f"({1e3 * s['seconds'] / max(s['linearizations'], 1):.2f} ms per iteration)")
    q = torch.tensor([res["q_i_c"][k] for k in "wxyz"], dtype=torch.float64)
    rot_err = float(torch.linalg.vector_norm(lie.quat_boxminus(
        q, torch.as_tensor(scene.q_i_c, dtype=torch.float64))))
    dt_err = abs(res["time_offset_imu_to_cam_s"] - TIME_OFFSET)
    ld = res["cam_line_delay"]
    reproj = res["final_reproj_error"]
    log(f"[main] CLI wall {wall:.2f} s; rotation error {rot_err:.2e} rad, time offset "
        f"error {dt_err * 1e3:.3f} ms, line delay {ld * 1e6:.3f} us (truth "
        f"{LINE_DELAY * 1e6:.3f}), mean reprojection error {reproj:.4f} px; "
        f"t_i_c {[res['t_i_c'][k] for k in 'xyz']}")
    log(f"[main] fused_gram launches {launches} ({counts}) for {n_lin} linearizations")
    checks = {
        "rotation error < 0.01 rad": rot_err < 0.01,
        "|time offset - truth| < 2 ms": dt_err < 2e-3,
        "line delay within 30% of truth": abs(ld - LINE_DELAY) < 0.3 * LINE_DELAY,
        "mean reprojection error < 0.35 px": reproj < 0.35,
        "finite result": all(math.isfinite(v) for v in
                             [reproj, ld, res["final_cost"]] + list(res["t_i_c"].values())),
        "3 kernel launches per linearization": launches == 3 * n_lin and all(
            counts.get(f, 0) == n_lin for f in ("obs", "accel", "gyro")),
    }
    for k, ok in checks.items():
        log(f"[main] check {k}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit("main path checks failed")
    for row in rows:
        row["launches"] = counts.get(row["tag"], 0)

    # One linearization of the same problem at its initial point.
    lin_ms = cuda_ms(lambda: lin(params0), warm=2, reps=5)
    log(f"[main] linearize {lin_ms:.2f} ms (CUDA events, mean of 5, D={D})")
    torch.cuda.empty_cache()

    banded_counts = banded_phase(torch, (se, banded, lm, gram, cli, io, lie), tmp)

    times, frames = render_phase(torch, recorded, render, synthetic, device)
    k2_row = k2_phase(torch, kernels, frames[0])
    k2_row["launches"] = intrinsics_phase(
        torch, (board_extractor, checkerboard, kernels, io, cal_cli), times, frames, tmp)
    del frames

    block_row, k3_row, charuco_corners = charuco_phase(
        torch, (board_extractor, video, kernels, quad_kernels, io, cal_cli, recorded, synthetic,
                cameras, lie), tmp)

    pipeline_counts, pipeline_checked, k2_pipeline, k3_pipeline = pipeline_phase(
        torch, (run_cal, imu_camera_calibrator, pose_estimator, imu_cam_rotation, se, gram,
                kernels, quad_kernels, io, lie, synthetic, cameras), st, charuco_corners, tmp)
    k2_row["launches_pipeline"], block_row["launches_pipeline"] = k2_pipeline
    k3_row["launches_pipeline"] = k3_pipeline[0]
    for row in rows:
        row["launches_banded"] = banded_counts.get(row["tag"], 0)
        row["launches_pipeline"] = pipeline_counts.get(row["tag"], 0)
        seen = pipeline_checked[row["tag"]]
        row["max_abs_err_pipeline"] = seen["max_abs_err"]
        row["shape_pipeline"] = {k: seen[k] for k in ("K", "R", "F", "L")}

    gopro_blocks, gopro_counts, gopro_checked, k3_gopro = gopro_phase(
        torch, (recorded, mp4_writer, board_extractor, gpmf, run_cal, io, gram, kernels,
                quad_kernels, lie), tmp)
    k2_row["launches_gopro"], block_row["launches_gopro"] = 0, gopro_blocks
    k3_row["launches_gopro"], k3_row["truncated_frames_gopro"] = k3_gopro[0], k3_gopro[2]
    for row in rows:
        row["launches_gopro"] = gopro_counts.get(row["tag"], 0)
        row["max_abs_err_gopro"] = gopro_checked[row["tag"]]["max_abs_err"]

    static_imu_phase(torch, (misc_tools, static_imu_calibrator, telemetry, io, synthetic), tmp)

    batch_rows, batch_counts = batch_phase(torch, (se, batch_estimator, lm, gram, lie))
    shard_counts = sharded_phase(torch, (se, sharded, schur, multihost, lm, gram))
    k2_cli, k1_cli, k3_cli = batch_cli_phase(
        torch, (recorded, board_extractor, camera_calibrator, io, batch_cli, kernels, quad_kernels,
                gram, lie), tmp)
    k2_row["launches_batch_cli"], block_row["launches_batch_cli"] = k2_cli[1], k2_cli[0]
    k3_row["launches_batch_cli"] = k3_cli[0]
    for row in rows:
        tag = row["tag"]
        row["launches_batch"] = batch_counts["independent"].get(tag, 0)
        row["launches_batch_joint"] = batch_counts["joint"].get(tag, 0)
        row["launches_sharded"] = shard_counts["sharded"].get(tag, 0)
        row["launches_schur"] = shard_counts["schur"].get(tag, 0)
        row["launches_batch_cli"] = k1_cli.get(tag, 0)

    shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        row.pop("tag")
    rows += list(batch_rows.values()) + [k2_row, block_row, k3_row]
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {name}")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
