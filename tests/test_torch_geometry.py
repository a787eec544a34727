"""Port parity: ops/lie.py, ops/spline.py, ops/interpolation.py.

The same numpy inputs (from a seed) go through the JAX function and its
PyTorch port, both in float64 on the CPU. Tolerances: 1e-12 absolute for
values (both compute the same float64 expression sequence, so only a few
ulps of reordering separate them); 1e-10 for derivatives taken through
nested forward-mode AD; 1e-9 near the small-angle and theta ~ pi branches,
where the Taylor and atan2 forms amplify last-bit differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.ops import interpolation as t_interp
from openimucameracalibrator_torch.ops import lie as t_lie
from openimucameracalibrator_torch.ops import spline as t_spline
from openimucameracalibrator_tpu.ops import interpolation as j_interp
from openimucameracalibrator_tpu.ops import lie as j_lie
from openimucameracalibrator_tpu.ops import spline as j_spline


def T(x):
    return torch.as_tensor(np.array(x, np.float64))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def random_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def tangent_vectors(rng):
    """Random axis-angles plus theta = 0, 1e-9, 1e-5 and theta near pi."""
    phi = rng.normal(size=(20, 3))
    axis = np.array([0.6, -0.8, 0.0])
    special = np.stack([0.0 * axis, 1e-9 * axis, 1e-5 * axis,
                        (np.pi - 1e-6) * axis, np.pi * axis])
    return np.concatenate([phi, special])


@pytest.mark.parametrize("fn", ["quat_multiply", "quat_rotate_conj", "quat_to_matrix",
                                "matrix_to_quat", "se3_compose", "se3_inverse", "se3_exp",
                                "quat_slerp", "boxplus_boxminus", "skew", "quat_inverse"])
def test_lie_values(fn, rng):
    q, p = random_quats(rng, 16), random_quats(rng, 16)
    v, t = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    cases = {
        "quat_multiply": lambda L, A: L.quat_multiply(A(q), A(p)),
        "quat_rotate_conj": lambda L, A: L.quat_rotate(L.quat_conjugate(A(q)), A(v)),
        "quat_to_matrix": lambda L, A: L.quat_to_matrix(A(q)),
        "matrix_to_quat": lambda L, A: L.matrix_to_quat(L.quat_to_matrix(A(q))),
        "se3_compose": lambda L, A: L.se3_compose(A(q), A(v), A(p), A(t)),
        "se3_inverse": lambda L, A: L.se3_inverse(A(q), A(v)),
        "se3_exp": lambda L, A: L.se3_exp(A(np.concatenate([v, tangent_vectors(rng)[:16]], 1))),
        "quat_slerp": lambda L, A: L.quat_slerp(A(q), A(p), A(rng.uniform(size=16))),
        "boxplus_boxminus": lambda L, A: L.quat_boxminus(L.quat_boxplus(A(q), A(v * 0.3)), A(q)),
        "skew": lambda L, A: L.skew(A(v)),
        "quat_inverse": lambda L, A: L.quat_inverse(A(q * 2.0)),
    }
    state = rng.bit_generator.state
    want = cases[fn](j_lie, jnp.asarray)
    rng.bit_generator.state = state
    got = cases[fn](t_lie, T)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(
            got if isinstance(got, tuple) else (got,))):
        np.testing.assert_allclose(N(b), np.asarray(a), rtol=0, atol=1e-12)


def test_so3_exp_log_small_angles_and_gradients(rng):
    phi = tangent_vectors(rng)
    np.testing.assert_allclose(N(t_lie.so3_exp(T(phi))), np.asarray(j_lie.so3_exp(jnp.asarray(phi))),
                               rtol=0, atol=1e-12)
    q = j_lie.so3_exp(jnp.asarray(phi))
    np.testing.assert_allclose(N(t_lie.so3_log(T(q))), np.asarray(j_lie.so3_log(q)),
                               rtol=0, atol=1e-9)
    # Jacobians of exp and log∘exp, including exactly at theta = 0 and at
    # 1e-9 (the NaN-gradient trap of where-guards).
    je = jax.jit(jax.vmap(jax.jacfwd(j_lie.so3_exp)))(jnp.asarray(phi))
    te = torch.func.vmap(torch.func.jacfwd(t_lie.so3_exp))(T(phi))
    np.testing.assert_allclose(N(te), np.asarray(je), rtol=0, atol=1e-9)
    jl = jax.jit(jax.vmap(jax.jacrev(lambda a: j_lie.so3_log(j_lie.so3_exp(a)))))(jnp.asarray(phi))
    tl = torch.func.vmap(torch.func.jacrev(lambda a: t_lie.so3_log(t_lie.so3_exp(a))))(T(phi))
    assert np.all(np.isfinite(N(tl)))
    np.testing.assert_allclose(N(tl), np.asarray(jl), rtol=0, atol=1e-9)


@pytest.mark.parametrize("order,deriv", [(6, 0), (6, 1), (6, 2), (3, 0), (4, 1)])
def test_blending_and_r3_eval(order, deriv, rng):
    np.testing.assert_array_equal(t_spline.blending_matrix(order, True),
                                  j_spline.blending_matrix(order, True))
    knots = rng.normal(size=(30, 3))
    t = rng.uniform(0.0, 2.4, 50)
    want = j_spline.r3_eval_batch(jnp.asarray(knots), jnp.asarray(t), 0.0, 0.1, deriv, order)
    got = t_spline.r3_eval_batch(T(knots), T(t), 0.0, 0.1, deriv, order)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=0, atol=1e-10)


def test_so3_spline_value_velocity_acceleration(rng):
    """Cumulative SO(3) spline value, body rate (jvp) and angular
    acceleration (nested jvp); the JAX side is one jitted function."""
    qk = random_quats(rng, 30)
    for k in range(1, 30):  # keep neighbouring knots in one hemisphere, near each other
        qk[k] = qk[k - 1] + 0.2 * qk[k]
        qk[k] /= np.linalg.norm(qk[k])
    t = rng.uniform(0.0, 2.4, 40)
    u = np.array([0.0, 0.37, 0.999])
    win = qk[4:10]

    @jax.jit
    def jax_side(qk_, t_, win_, u_):
        return (j_spline.so3_eval_batch(qk_, t_, 0.0, 0.1),
                j_spline.so3_vel_batch(qk_, t_, 0.0, 0.1)[1],
                jax.vmap(lambda uu: j_spline.so3_accel(win_, uu, 0.1, 6))(u_))

    j_q, j_w, j_acc = jax_side(*map(jnp.asarray, (qk, t, win, u)))
    np.testing.assert_allclose(N(t_spline.so3_eval_batch(T(qk), T(t), 0.0, 0.1)),
                               np.asarray(j_q), rtol=0, atol=1e-12)
    np.testing.assert_allclose(N(t_spline.so3_vel_batch(T(qk), T(t), 0.0, 0.1)[1]),
                               np.asarray(j_w), rtol=0, atol=1e-10)
    got = torch.func.vmap(lambda uu: t_spline.so3_accel(T(win), uu, 0.1, 6))(T(u))
    for a, b in zip(j_acc, got):
        np.testing.assert_allclose(N(b), np.asarray(a), rtol=0, atol=1e-9)


def test_spline_coords_and_gather(rng):
    t = np.concatenate([rng.uniform(-0.5, 3.0, 30), [0.0, 0.1, 2.5]])
    ji, ju = j_spline.spline_coords(jnp.asarray(t), 0.0, 0.1, 25, 6)
    ti, tu = t_spline.spline_coords(T(t), 0.0, 0.1, 25, 6)
    np.testing.assert_array_equal(N(ti), np.asarray(ji))
    np.testing.assert_allclose(N(tu), np.asarray(ju), rtol=0, atol=1e-12)
    knots = rng.normal(size=(25, 4))
    np.testing.assert_array_equal(N(t_spline.gather_window(T(knots), ti, 6)),
                                  np.asarray(j_spline.gather_window(jnp.asarray(knots), ji, 6)))


def test_interpolation(rng):
    times = np.sort(rng.uniform(0, 5, 40))
    vals = rng.normal(size=(40, 3))
    quats = random_quats(rng, 40)
    for k in range(1, 40):
        if quats[k] @ quats[k - 1] < 0:
            quats[k] = -quats[k]
    query = rng.uniform(-0.5, 5.5, 60)
    np.testing.assert_allclose(
        N(t_interp.interp_vector(T(times), T(vals), T(query))),
        np.asarray(j_interp.interp_vector(jnp.asarray(times), jnp.asarray(vals), jnp.asarray(query))),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        N(t_interp.interp_quaternion(T(times), T(quats), T(query))),
        np.asarray(j_interp.interp_quaternion(jnp.asarray(times), jnp.asarray(quats),
                                              jnp.asarray(query))),
        rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        N(t_interp.closest_index(T(times), T(query))),
        np.asarray(j_interp.closest_index(jnp.asarray(times), jnp.asarray(query))))
    np.testing.assert_allclose(
        N(t_interp.moving_average(T(vals), 5)),
        np.asarray(j_interp.moving_average(jnp.asarray(vals), 5)), rtol=0, atol=1e-12)
