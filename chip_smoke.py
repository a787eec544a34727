#!/usr/bin/env python3
"""Run the PyTorch port's stage-8 main path on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (every failure exits non-zero; nothing is caught and carried on):

1. device   — the card's name, and its name and power limit per nvidia-smi.
2. build    — build the fused densify + Gram CUDA kernel (csrc/gram.cu).
3. scene    — the DS3-scale synthetic recording (60 s, 60 fps, 200 Hz IMU,
              960x540 division-undistortion camera, rolling shutter,
              charuco 10x8) rendered on the card, and its stage-8 input
              artifacts written to a temporary directory.
4. kernels  — the kernel against its plain PyTorch version at the three
              family shapes of that recording's chunk plan, with times.
5. main     — the port's stage-8 CLI on those artifacts on the card, with
              its default iteration caps; recovery of the truth, and the
              kernel launches counted during the run; then the time of one
              linearization of the same problem.

The line before the last is a JSON object listing every ported kernel; the
last line is ``{"ok": true, "device": {...}}``. Needs one CUDA device and
the ``openimucameracalibrator_torch`` package beside this script; imports
nothing of the JAX package.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

DURATION = 60.0
CAM_FPS = 60.0
IMU_RATE = 200.0
LINE_DELAY = 30.895e-6
TIME_OFFSET = -0.0813
CAM = [437.13, 489.07, 270.87, -1.4386e-06]
SEW = dict(dt_so3=0.050, dt_r3=0.089, std_so3=0.002, std_r3=0.02)
INIT_ROT_ERR, INIT_TIME_ERR = 3e-3, 3e-3  # rotation-init perturbation: rad, s

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 CUDA-core FLOP/s.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SOURCE = "openimucameracalibrator_torch/csrc/gram.cu"
REPLACES = "openimucameracalibrator_tpu/solver/pallas_gram.py:119"


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


def family_shapes(se, problem):
    """(name, K, R, rd, F, segments, L) per family of the DS3 chunk plan, as
    the linearizer hands them to the kernel; and the tangent dimension."""
    plans, _ = se.plan_fast_assembly(problem, 4096, 256)
    out = [(name, plan.n_chunks, plan.chunk * rd, rd, F, segs, L)
           for plan, (name, (rd, F, segs, L)) in zip(
               plans, se.gram_layouts(problem, plans).items())]
    return out, se.build_layout(problem).tangent_dim


def kernel_phase(gram, shapes):
    """Kernel vs plain version at each family shape; returns per-family rows."""
    import torch

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, K, R, rd, F, segs, L in shapes:
        J = torch.randn((K, R, F), generator=gen, device="cuda")
        r = torch.randn((K, R), generator=gen, device="cuda")
        idx = []
        for s in segs:
            if s[0] == "run":
                _, _, nblk, _, wblk, _ = s
                m = torch.randint(0, wblk - nblk + 1, (K, R // rd), generator=gen, device="cuda")
                idx.append(m.repeat_interleave(rd, dim=1))
        idx = torch.stack(idx).to(torch.int32).contiguous()
        n_run = idx.shape[0]

        H, g = gram.fused_gram(J, r, idx, segs, L)
        torch.cuda.synchronize()
        Hp, gp = gram.fused_gram_plain(J, r, idx, segs, L)
        err_h = (H - Hp).abs().max().item()
        err_g = (g - gp).abs().max().item()
        scale_h, scale_g = Hp.abs().max().item(), gp.abs().max().item()
        # fp32 rounding of an R-term sum, scaled by the largest entry.
        tol = 8.0 * math.sqrt(R) * torch.finfo(torch.float32).eps
        rel_h, rel_g = err_h / scale_h, err_g / scale_g
        log(f"kernel[{name}] K={K} R={R} F={F} L={L} n_run={n_run}: "
            f"H max_abs_err={err_h:.3e} rel={rel_h:.3e}, g max_abs_err={err_g:.3e} "
            f"rel={rel_g:.3e} (tolerance rel {tol:.3e})")
        if not (rel_h <= tol and rel_g <= tol and math.isfinite(err_h) and math.isfinite(err_g)):
            raise SystemExit(f"kernel[{name}] disagrees with its plain version")

        def library():
            D, rf = gram._densify_segments(r[:, :, None], J[:, :, None, :],
                                           gram._per_row_segments(segs, idx), L)
            return torch.bmm(D.transpose(1, 2), D), torch.bmm(D.transpose(1, 2), rf[..., None])

        plain_ms = cuda_ms(lambda: gram.fused_gram_plain(J, r, idx, segs, L))
        kernel_ms = cuda_ms(lambda: gram.fused_gram(J, r, idx, segs, L))
        kernel_ms2 = cuda_ms(lambda: gram.fused_gram(J, r, idx, segs, L))
        library_ms = cuda_ms(library)
        plain_ms2 = cuda_ms(lambda: gram.fused_gram_plain(J, r, idx, segs, L))
        # Least time for the same work: each input read once, each output
        # written once; the operations this data needs (F nonzeros per row
        # of D: the upper triangle of each row's outer product, plus g).
        nbytes = K * R * (F + 1 + n_run) * 4 + K * (L * L + L) * 4
        ops = K * R * (F * (F + 1) + 2 * F)
        dense_ops = 2 * K * R * L * L
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_FLOP_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        log(f"kernel[{name}] kernel_ms={kernel_ms:.4f},{kernel_ms2:.4f} "
            f"plain_ms={plain_ms:.4f},{plain_ms2:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) "
            f"dense_bound_ms={dense_ops / FP32_FLOP_S * 1e3:.4f} ({dense_ops / 1e9:.2f} GFLOP)")
        rows.append(dict(name=f"fused_gram[{name}]", route="cuda", source=SOURCE,
                         replaces=REPLACES, launches=0,
                         max_abs_err=max(err_h, err_g),
                         ms=min(kernel_ms, kernel_ms2), plain_ms=min(plain_ms, plain_ms2),
                         bound_ms=bound_ms,
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         library_ms=library_ms, tag=name))
        del J, r, idx, H, g, Hp, gp
        torch.cuda.empty_cache()
    return rows


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
    from openimucameracalibrator_torch.apps import continuous_time_calibration as cli
    from openimucameracalibrator_torch.core import spline_estimator as se
    from openimucameracalibrator_torch.models import cameras
    from openimucameracalibrator_torch.ops import lie
    from openimucameracalibrator_torch.solver import gram
    from openimucameracalibrator_torch.utils import io, precision, synthetic

    t_start = time.perf_counter()
    device = precision.resolve_device("cuda")  # also turns TF32 off
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    lib = gram.build()
    log(f"[build] {lib.path} in {lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")

    tmp = tempfile.mkdtemp(prefix="oicc_chip_smoke_")
    t0 = time.perf_counter()
    scene = synthetic.make_imu_camera_scene(
        cameras.get_model("division_undistortion"), CAM, duration=DURATION,
        cam_fps=CAM_FPS, imu_rate=IMU_RATE, image_size=(960, 540), noise_px=0.2,
        time_offset=TIME_OFFSET, line_delay=LINE_DELAY, seed=7, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    paths = synthetic.write_stage8_inputs(scene, tmp, cam_fps=CAM_FPS, **SEW,
                                          init_rot_err=INIT_ROT_ERR,
                                          init_time_err=INIT_TIME_ERR)
    corners = io.load_corners(paths["input_corners"])
    log(f"[scene] {len(scene.frame_times)} views, {int(scene.obs_valid.sum())} valid of "
        f"{scene.obs_valid.size} observations, {len(scene.imu_times)} IMU samples; "
        f"rendered in {t1 - t0:.2f} s, artifacts written in {time.perf_counter() - t1:.2f} s")
    from openimucameracalibrator_torch.utils.types import ImuData, SplineWeightingData
    imu = ImuData(times=scene.imu_times, accel=scene.accel, gyro=scene.gyro)
    sew = SplineWeightingData(cam_fps=CAM_FPS, **SEW)
    problem = se.build_problem(corners, io.load_camera_calibration(
        paths["camera_calibration_json"]), imu, sew, TIME_OFFSET + INIT_TIME_ERR,
        rolling_shutter=True, device=device)
    shapes, D = family_shapes(se, problem)
    log(f"[scene] tangent dim D={D}; chunk plan: " + "; ".join(
        f"{n} K={K} R={R} F={F} L={L}" for n, K, R, _, F, _, L in shapes))

    rows = kernel_phase(gram, shapes)

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
    from openimucameracalibrator_torch.apps.estimate_imu_to_camera_rotation import \
        load_imu_camera_init
    from openimucameracalibrator_torch.apps.estimate_poses import load_pose_dataset
    init = load_imu_camera_init(paths["imu_rotation_init"])
    qg = init.q_gyro_to_cam
    params0 = se.init_spline_params(
        load_pose_dataset(paths["input_pose_dataset"]), [qg[0], -qg[1], -qg[2], -qg[3]],
        [0.0, 0.0, 0.0],
        problem, imu, pose_time_offset=init.time_offset, device=device)
    params0["line_delay"] = torch.tensor([1.0 / CAM_FPS / 540], device=device)
    lin, _ = se.make_solver_functions_fast(problem, se.build_layout(problem))
    lin_ms = cuda_ms(lambda: lin(params0), warm=2, reps=5)
    log(f"[main] linearize {lin_ms:.2f} ms (CUDA events, mean of 5, D={D})")


    shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        row.pop("tag")
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {name}")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
