"""Port parity: parallel/multihost.py, and a real 2-process solve.

The four host-side cases of ``tests/test_multihost.py`` (no coordinator is
a no-op, the time slices partition the recording, the per-process problem
round trip, the row-count agreement on one process), then:

* ``test_two_process_distributed_solve``: two processes join a gloo group
  over a free localhost port; each loads only its time slice of the tiny
  problem (``host_time_range`` / ``host_shard``), agrees the row counts
  with a real ``all_gather`` and runs the data-parallel and the
  knot-sharded Schur LM with all-reduced normal equations; the test holds
  both ranks' solutions against the single-process solve in float64 (the
  same iterations, cost 1e-9 relative, parameters 1e-8), as
  ``tests/multihost_worker.py`` holds the JAX package's;
* the CLIs' multi-process flags join a world-size-1 gloo group.

The workers are this file's ``__main__`` block, so they import no JAX.
Every subprocess has a 120 s timeout; on expiry its children are killed
and the test fails.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from openimucameracalibrator_torch.core import spline_estimator as se  # noqa: E402
from openimucameracalibrator_torch.ops import lie  # noqa: E402
from openimucameracalibrator_torch.parallel import multihost  # noqa: E402
from openimucameracalibrator_torch.solver import lm  # noqa: E402

TIMEOUT_S = 120
FLAGS = se.DEFAULT_FLAGS | {se.CAM_LINE_DELAY, se.TIME_OFFSET}
CHUNKS = dict(obs_chunk=64, imu_chunk=32)
LM = dict(max_iters=3, ftol=0.0)


def _tiny_problem():
    """``__graft_entry__._tiny_problem(float64)`` built with the port (the
    same numpy draws), so that the workers import no JAX."""
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)  # noqa: E731
    rng = np.random.default_rng(0)
    dur, dt = 2.0, 0.2
    n_knots = int(np.ceil(dur / dt)) + se.ORDER - 1
    n_bias = 1 + se.BIAS_ORDER - 1 + 1
    ma, mo = 100, 240
    accel_t = np.linspace(0.05, dur - 0.25, ma)
    obs_t = np.repeat(np.linspace(0.05, dur - 0.25, mo // 12), 12)
    p = se.SplineProblem(
        t0=0.0, dt_so3=dt, dt_r3=dt, dt_bias=dur, n_so3=n_knots, n_r3=n_knots, n_bias=n_bias,
        accel_t=T(accel_t), accel_meas=T(rng.normal(size=(ma, 3)) * 0.1 + [0, 0, 9.81]),
        accel_valid=torch.ones(ma, dtype=torch.bool), w_accel=50.0,
        gyro_t=T(accel_t), gyro_meas=T(rng.normal(size=(ma, 3)) * 0.1),
        gyro_valid=torch.ones(ma, dtype=torch.bool), w_gyro=500.0,
        obs_t=T(obs_t), obs_row=T(rng.uniform(0, 540, mo)),
        obs_uv=T(rng.uniform(100, 500, (mo, 2))),
        obs_pt=T(rng.uniform(0, 0.3, (mo, 3)) * [1, 1, 0]),
        obs_valid=torch.ones(mo, dtype=torch.bool),
        cam_params=T([437.0, 437.0, 480.0, 270.0]), model_name="pinhole",
        rolling_shutter=True)
    params = {
        "q_so3": T(np.tile([1.0, 0, 0, 0], (n_knots, 1))),
        "t_r3": T(rng.normal(size=(n_knots, 3)) * 0.05 + [0.15, 0.15, 0.8]),
        "bias_a": T(np.zeros((n_bias, 3))), "bias_g": T(np.zeros((n_bias, 3))),
        "gravity": T([0.0, 0.0, 9.81]),
        "q_i_c": lie.so3_exp(T([0.0, 0.0, np.pi / 2])),
        "t_i_c": T(np.zeros(3)), "line_delay": T([30e-6]), "time_offset": T(np.zeros(1)),
        "accl_intr": se.identity_accl_intr(torch.float64, "cpu"),
        "gyro_intr": se.identity_gyro_intr(torch.float64, "cpu"),
    }
    return p, params


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(cmds):
    """Start every command, wait at most TIMEOUT_S for all of them; on
    expiry kill them all and fail. Returns [(returncode, output)]."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT) for c in cmds]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=TIMEOUT_S)
            outs.append((pr.returncode, out))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a subprocess did not finish within {TIMEOUT_S} s")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return outs


def test_tiny_problem_is_the_graft_entry_problem():
    import jax.numpy as jnp

    import __graft_entry__ as ge

    jp, jparams = ge._tiny_problem(jnp.float64)
    p, params = _tiny_problem()
    for k, v in jp._asdict().items():
        got = getattr(p, k)
        if hasattr(v, "shape"):
            np.testing.assert_allclose(got.numpy(), np.asarray(v), rtol=1e-15, atol=0,
                                       err_msg=k)
        else:
            assert got == v, k
    for k, v in jparams.items():
        np.testing.assert_allclose(params[k].numpy(), np.asarray(v), rtol=0, atol=1e-15,
                                   err_msg=k)


def test_initialize_noop_single_host(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert multihost.initialize() is False  # no coordinator -> no-op
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("127.0.0.1:1", num_processes=2, process_id=2, device="cpu")


def test_host_time_range_partitions():
    ranges = [multihost.host_time_range(0.0, 10.0, process_id=i, num_processes=4)
              for i in range(4)]
    assert ranges[0][0] == 0.0 and ranges[-1][1] == 10.0
    for (a, b), (c, d) in zip(ranges, ranges[1:]):
        assert b == c  # contiguous, no gap/overlap
    t = np.linspace(0, 9.999, 1000)
    masks = [multihost.host_shard(t, lo, hi) for lo, hi in ranges]
    assert np.all(sum(m.astype(int) for m in masks) == 1)  # exactly one owner


def test_make_global_problem_single_host_roundtrip():
    rng = np.random.default_rng(0)
    ma, mo = 64, 96
    mesh = multihost.global_mesh(device="cpu")
    assert mesh.n == 1 and mesh.group is None
    meta = dict(t0=0.0, dt_so3=0.1, dt_r3=0.1, dt_bias=2.0, n_so3=25, n_r3=25, n_bias=4,
                w_accel=50.0, w_gyro=500.0, cam_params=np.asarray([437.0, 437.0, 480.0, 270.0]),
                model_name="pinhole", rolling_shutter=False)
    local = dict(
        accel_t=np.linspace(0, 2, ma), accel_meas=rng.normal(size=(ma, 3)),
        accel_valid=np.ones(ma, bool),
        gyro_t=np.linspace(0, 2, ma), gyro_meas=rng.normal(size=(ma, 3)),
        gyro_valid=np.ones(ma, bool),
        obs_t=np.repeat(np.linspace(0, 2, mo // 8), 8),
        obs_row=rng.uniform(0, 540, mo), obs_uv=rng.uniform(0, 500, (mo, 2)),
        obs_pt=rng.uniform(0, 0.3, (mo, 3)), obs_valid=np.ones(mo, bool))
    p = multihost.make_global_problem(local, meta, mesh)
    assert isinstance(p, se.SplineProblem)
    np.testing.assert_array_equal(p.accel_t.numpy(), local["accel_t"])
    assert p.accel_t.device == mesh.device and p.accel_valid.dtype == torch.bool
    # Padding to a common per-process row count stays valid-masked.
    p2 = multihost.make_global_problem(local, meta, mesh,
                                       per_host_rows={"accel": 80, "gyro": 80, "obs": 120})
    assert p2.accel_t.shape[0] == 80
    assert int(p2.accel_valid.sum()) == ma
    assert float(p2.accel_t[-1]) == local["accel_t"][-1]  # pads keep the window local


def test_agree_per_host_rows_single():
    rows = multihost.agree_per_host_rows(
        dict(accel_t=np.zeros(7), accel_meas=np.zeros((7, 3)), gyro_t=np.zeros(5),
             obs_t=np.zeros(11)))
    assert rows == {"accel": 7, "gyro": 5, "obs": 11}


def test_two_process_distributed_solve(tmp_path):
    """Two real processes (gloo on the CPU); the sharded and Schur LMs
    all-reduce their normal equations across them and must match the
    single-process solve."""
    port = _free_port()
    outs = _run([[sys.executable, __file__, "worker", str(i), "2", str(port), str(tmp_path)]
                 for i in range(2)])
    for i, (rc, out) in enumerate(outs):
        assert rc == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"OK pid={i}" in out, f"worker {i} printed no OK line:\n{out[-4000:]}"
    p_full, params0 = _tiny_problem()
    ref = se.optimize(p_full, params0, flags=FLAGS, config=lm.LMConfig(**LM))
    for name in ("sharded", "schur"):
        got = [np.load(tmp_path / f"{name}_{i}.npz") for i in range(2)]
        for k in ref.params:  # both processes hold the same replicated solution
            np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=(name, k))
            np.testing.assert_allclose(got[0][k], ref.params[k].numpy(), rtol=0, atol=1e-8,
                                       err_msg=(name, k))
        assert int(got[0]["iterations"]) == ref.iterations, name
        np.testing.assert_allclose(float(got[0]["cost"]), float(ref.cost), rtol=1e-9)


def test_cli_multiprocess_flags_join_a_group():
    """--coordinator_address/--num_processes/--process_id make both CLIs
    join a world-size-1 gloo group and go on (here to the missing inputs)."""
    port = _free_port()
    (rc, out), = _run([[sys.executable, __file__, "cli", str(port)]])
    assert rc == 0, out[-4000:]
    assert out.count("torch.distributed: process 0/1, backend gloo") == 2, out[-4000:]
    assert "CLI continuous_time_calibration: FileNotFoundError" in out, out[-4000:]
    assert "CLI run_calibration: FileNotFoundError" in out, out[-4000:]


def _worker(pid, nproc, port, out_dir):
    from openimucameracalibrator_torch.parallel import schur, sharded

    torch.set_num_threads(1)  # two ranks beside the test run's other workers
    assert multihost.initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu",
                                timeout_s=TIMEOUT_S)
    assert multihost.process_count() == nproc and multihost.process_index() == pid
    p_full, params0 = _tiny_problem()

    # Per-process loading: this process materializes only its time slice.
    t_lo = float(min(p_full.accel_t.min(), p_full.obs_t.min()))
    t_hi = float(max(p_full.accel_t.max(), p_full.obs_t.max())) + 1e-6
    lo, hi = multihost.host_time_range(t_lo, t_hi)
    local = {}
    for fam, tkey in (("accel", "accel_t"), ("gyro", "gyro_t"), ("obs", "obs_t")):
        m = multihost.host_shard(getattr(p_full, tkey).numpy(), lo, hi)
        for f in se.SplineProblem._fields:
            v = getattr(p_full, f)
            if f.startswith(fam) and isinstance(v, torch.Tensor):
                local[f] = v.numpy()[m]
    meta = {f: getattr(p_full, f) for f in
            ("t0", "dt_so3", "dt_r3", "dt_bias", "n_so3", "n_r3", "n_bias", "w_accel",
             "w_gyro", "cam_params", "model_name", "rolling_shutter")}
    rows = multihost.agree_per_host_rows(local)  # a real all_gather
    mesh = multihost.global_mesh()
    assert mesh.n == nproc and mesh.local == (pid,) and mesh.group is not None
    p_local = multihost.make_global_problem(local, meta, mesh, per_host_rows=rows)
    assert int(p_local.obs_valid.sum()) < int(p_full.obs_valid.sum())

    for name, run in (("sharded", sharded.optimize_sharded), ("schur", schur.optimize_schur)):
        res = run(p_local, params0, mesh, FLAGS, config=lm.LMConfig(**LM), **CHUNKS)
        np.savez(os.path.join(out_dir, f"{name}_{pid}.npz"), cost=float(res.cost),
                 iterations=res.iterations, **{k: v.numpy() for k, v in res.params.items()})
    print(f"OK pid={pid}", flush=True)


def _cli(port):
    from openimucameracalibrator_torch.apps import continuous_time_calibration as ctc
    from openimucameracalibrator_torch.apps import run_calibration as rc

    torch.set_num_threads(1)
    flags = ["--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "1",
             "--process_id", "0", "--device", "cpu"]
    missing = os.path.join(os.path.dirname(__file__), "no_such_input")
    for name, main, argv in (
            ("continuous_time_calibration", ctc.main,
             ["--input_corners", missing, "--camera_calibration_json", missing,
              "--input_pose_dataset", missing, "--telemetry_json", missing,
              "--imu_rotation_init", missing, "--spline_weighting_json", missing,
              "--output_path", missing]),
            ("run_calibration", rc.main,
             ["--path_calib_dataset", missing, "--telemetry_json", missing])):
        try:
            main(argv + flags)
        except FileNotFoundError:
            print(f"CLI {name}: FileNotFoundError", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        _cli(sys.argv[2])
