"""The port's static multi-pose IMU calibration, RK4 gyro integration and
Allan-variance analysis against the JAX package's, on the CPU in float64.

Tolerances: the RK4 integration and the Allan deviation to 1e-12
relative (the same float64 operations in the same order); every fitted
parameter (accelerometer and gyroscope misalignment, scale, bias; the
Allan {Q, N, B, K, R}) to 1e-8 relative, as asked of a float64 port of an
LM fit; the multi-pose generator's readings to 1e-12 absolute.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_tpu.core import static_imu_calibrator as j_static
from openimucameracalibrator_tpu.ops import allan as j_allan
from openimucameracalibrator_tpu.ops import imu_integration as j_integ
from openimucameracalibrator_torch.apps import misc_tools
from openimucameracalibrator_torch.core import static_imu_calibrator as t_static
from openimucameracalibrator_torch.core import telemetry as t_telemetry
from openimucameracalibrator_torch.ops import allan as t_allan
from openimucameracalibrator_torch.ops import imu_integration as t_integ
from openimucameracalibrator_torch.utils import io as t_io
from openimucameracalibrator_torch.utils import synthetic as t_synthetic
from openimucameracalibrator_torch.utils.types import CameraTelemetry, ImuData
from test_static_imu import G, TRUE_B_A, TRUE_B_G, TRUE_K_A, TRUE_K_G, TRUE_T_A, TRUE_T_G
from test_static_imu import make_multipose_data

OPTS = dict(init_static_duration_s=5.0, min_intervals=12, min_interval_samples=150)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _segments(rng, M=4, N=60, pad=(0, 7, 0, 19)):
    """M gyro sequences of N samples, the k-th padded with pad[k] dt = 0
    steps of zero rate (as the calibrator pads its segments)."""
    t = np.cumsum(rng.uniform(0.004, 0.006, size=(M, N)), axis=1)
    w = rng.normal(size=(M, N, 3)) * 1.5
    for k, p in enumerate(pad):
        if p:
            t[k, -p:] = t[k, -p - 1]
            w[k, -p:] = 0.0
    return t, w


def test_rk4_integration_matches_jax():
    t, w = _segments(np.random.default_rng(0))
    want = np.asarray(jax.jit(jax.vmap(j_integ.integrate_gyro))(jnp.asarray(t), jnp.asarray(w)))
    got = t_integ.integrate_gyro(torch.as_tensor(t), torch.as_tensor(w)).numpy()
    assert _rel(got, want) < 1e-12
    q0 = np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2])
    step_j = j_integ.rk4_step(jnp.asarray(q0), jnp.asarray(w[0, 0]), jnp.asarray(w[0, 1]),
                              jnp.asarray(0.01))
    step_t = t_integ.rk4_step(torch.as_tensor(q0), torch.as_tensor(w[0, 0]),
                              torch.as_tensor(w[0, 1]), torch.tensor(0.01, dtype=torch.float64))
    assert _rel(step_t.numpy(), np.asarray(step_j)) < 1e-12


def test_padding_steps_leave_the_orientation_unchanged():
    t, w = _segments(np.random.default_rng(1))
    full = t_integ.integrate_gyro(torch.as_tensor(t[1]), torch.as_tensor(w[1]))
    cut = t_integ.integrate_gyro(torch.as_tensor(t[1, :-7]), torch.as_tensor(w[1, :-7]))
    torch.testing.assert_close(full, cut, rtol=0, atol=1e-15)


def test_multipose_generator_matches_the_jax_tests():
    """synthetic.make_multipose_imu draws what tests/test_static_imu.py's
    generator draws (the chip check uses the port's, which needs no JAX)."""
    want = make_multipose_data(np.random.default_rng(5), n_poses=3)
    got = t_synthetic.make_multipose_imu(np.random.default_rng(5), n_poses=3)
    np.testing.assert_array_equal(got.times, want.times)
    for k in ("accel", "gyro"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    """The static-imu-calibration tool on the CPU on the JAX tests' data,
    and the JAX calibration of the same telemetry."""
    d = tmp_path_factory.mktemp("static_imu")
    imu = t_synthetic.make_multipose_imu(np.random.default_rng(42))
    tel_path, out = str(d / "telemetry.json"), str(d / "imu_intrinsics.json")
    t_telemetry.write_generic_json(CameraTelemetry(imu=imu), tel_path)
    info = misc_tools.static_imu_main([
        "--telemetry_json", tel_path, "--output_path", out, "--gravity_const", str(G),
        "--initial_static_duration_s", str(OPTS["init_static_duration_s"]), "--device", "cpu"])
    read = t_telemetry.read_generic_json(tel_path).imu
    want = j_static.calibrate(read, j_static.StaticImuCalibratorOptions(
        gravity=G, init_static_duration_s=OPTS["init_static_duration_s"]))
    return imu, out, info, want


def test_static_imu_tool_matches_jax(tool_run):
    """The tool writes what io.load_imu_intrinsics reads (run_calibration's
    --imu_intrinsics_json), equal to the JAX calibration to 1e-8."""
    _, out, info, (ja, jg, jinfo) = tool_run
    acc, gyr = t_io.load_imu_intrinsics(out)
    with open(out) as f:
        assert json.load(f)["info"] == {"num_intervals": jinfo["num_intervals"],
                                        "threshold_mult": jinfo["threshold_mult"]}
    assert info["gyro_cost"] == pytest.approx(jinfo["gyro_cost"], rel=1e-8)
    assert info["gyro_linearizations"] >= 1 and info["gyro_seconds"] > 0
    for got, want in ((acc, ja), (gyr, jg)):
        for k in ("misalignment", "scale", "bias"):
            assert _rel(getattr(got, k), getattr(want, k)) < 1e-8, k


def test_static_imu_calibration_recovers_truth(tool_run):
    """tests/test_static_imu.py's bars on the port's result."""
    imu, out, info, _ = tool_run
    acc, gyr = t_io.load_imu_intrinsics(out)
    assert info["num_intervals"] >= 12
    np.testing.assert_allclose(acc.scale, TRUE_K_A, atol=5e-3)
    np.testing.assert_allclose(acc.bias, TRUE_B_A, atol=2e-2)
    np.testing.assert_allclose(acc.misalignment, TRUE_T_A, atol=5e-3)
    np.testing.assert_allclose(gyr.scale, TRUE_K_G, atol=1e-2)
    np.testing.assert_allclose(gyr.bias, TRUE_B_G, atol=2e-3)
    np.testing.assert_allclose(gyr.misalignment, TRUE_T_G, atol=1e-2)
    cal = acc.unbias_normalize(imu.accel[:400])
    np.testing.assert_allclose(np.linalg.norm(cal, axis=1).mean(), G, atol=0.02)


def test_accelerometer_fit_matches_jax():
    rng = np.random.default_rng(3)
    g_dirs = rng.normal(size=(14, 3))
    g_dirs *= G / np.linalg.norm(g_dirs, axis=1, keepdims=True)
    tka_inv = np.linalg.inv(TRUE_T_A @ np.diag(TRUE_K_A))
    means = g_dirs @ tka_inv.T + TRUE_B_A + 1e-3 * rng.normal(size=(14, 3))
    ja, jcost = j_static.calibrate_accelerometer(means, G)
    ta, tcost = t_static.calibrate_accelerometer(means, G, device="cpu")
    assert tcost == pytest.approx(jcost, rel=1e-8)
    for k in ("misalignment", "scale", "bias"):
        assert _rel(getattr(ta, k), getattr(ja, k)) < 1e-8, k


def _allan_signal(n=12000, rate=100.0):
    """White noise plus a bias random walk plus a slow ramp."""
    rng = np.random.default_rng(11)
    walk = np.cumsum(rng.normal(size=(n, 3)), axis=0) * 2e-4
    ramp = np.arange(n)[:, None] / rate * np.array([1e-5, -2e-5, 3e-5])
    return 0.01 * rng.normal(size=(n, 3)) + walk + ramp, rate


def test_allan_matches_jax():
    x, rate = _allan_signal()
    got, want = t_allan.analyze(x, rate, device="cpu"), j_allan.analyze(x, rate)
    np.testing.assert_array_equal(got.taus, want.taus)
    assert _rel(got.adev, want.adev) < 1e-12
    for k in range(3):
        assert _rel(got.params[k], want.params[k]) < 1e-8, (got.params[k], want.params[k])
    for prop in ("white_noise_density", "bias_instability", "random_walk"):
        assert _rel(getattr(got, prop), getattr(want, prop)) < 1e-8
    np.testing.assert_array_equal(t_allan.cluster_sizes(5000), j_allan.cluster_sizes(5000))


def test_allan_tool(tmp_path, capsys):
    x, rate = _allan_signal(n=6000)
    tel_path, out = str(tmp_path / "t.json"), str(tmp_path / "allan.json")
    imu = ImuData(times=np.arange(len(x)) / rate, accel=x + [0, 0, G], gyro=x)
    t_telemetry.write_generic_json(CameraTelemetry(imu=imu), tel_path)
    misc_tools.allan_main(["--telemetry_json", tel_path, "--output_path", out,
                           "--device", "cpu"])
    with open(out) as f:
        got = json.load(f)
    read = t_telemetry.read_generic_json(tel_path).imu
    want = j_allan.analyze(read.gyro, read.rate_hz)
    assert _rel(got["gyro"]["white_noise_density"], want.white_noise_density) < 1e-8
    assert set(got) == {"gyro", "accel"} and "white_noise_density" in capsys.readouterr().out
