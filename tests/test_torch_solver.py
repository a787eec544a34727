"""Port parity: solver/blocks.py, solver/robust.py and solver/lm.py.

The LM parity runs one small nonlinear least-squares problem (a rotation,
a translation and a scale fitted to noisy point pairs, started 2.5 rad
away) through the JAX ``lax.while_loop`` and the port's host loop, for the
classic and the fused strategy. Both take the same inputs in float64;
the iteration count and status must be equal, and the cost history and
solution agree to 1e-9 relative (float64 linear algebra in a different
library: LAPACK through XLA vs torch, a few ulps per step, carried over
a few dozen steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.ops import lie as t_lie
from openimucameracalibrator_torch.solver import blocks as t_blocks
from openimucameracalibrator_torch.solver import lm as t_lm
from openimucameracalibrator_torch.solver import robust as t_robust
from openimucameracalibrator_tpu.ops import lie as j_lie
from openimucameracalibrator_tpu.solver import blocks as j_blocks
from openimucameracalibrator_tpu.solver import lm as j_lm
from openimucameracalibrator_tpu.solver import robust as j_robust


def T(x):
    return torch.as_tensor(np.array(x, np.float64))


def specs(mod):
    return [mod.BlockSpec("q", (4,), "quat"), mod.BlockSpec("knots", (5, 3)),
            mod.BlockSpec("s", (2,))]


def test_block_layout_retract_and_mask(rng):
    jl, tl = j_blocks.BlockLayout(specs(j_blocks)), t_blocks.BlockLayout(specs(t_blocks))
    assert jl.offsets == tl.offsets and jl.tangent_dim == tl.tangent_dim == 20
    q = rng.normal(size=4)
    params = {"q": q / np.linalg.norm(q), "knots": rng.normal(size=(5, 3)), "s": rng.normal(size=2)}
    delta = rng.normal(size=20) * 0.3
    want = jl.retract({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(delta))
    got = tl.retract({k: T(v) for k, v in params.items()}, T(delta))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-14)
    pm = {"s": np.array([1.0, 0.0])}
    np.testing.assert_array_equal(tl.free_mask(["q"], pm).numpy(),
                                  np.asarray(jl.free_mask(["q"], pm)))
    idx = np.array([0, 3, 4])
    np.testing.assert_array_equal(tl.global_indices("knots", torch.as_tensor(idx)).numpy(),
                                  np.asarray(jl.global_indices("knots", jnp.asarray(idx))))


@pytest.mark.parametrize("group_size", [1, 2])
def test_huber(group_size, rng):
    r = rng.normal(size=64) * 2.0
    np.testing.assert_allclose(t_robust.huber_sqrt_weights(T(r), 1.345, group_size).numpy(),
                               np.asarray(j_robust.huber_sqrt_weights(jnp.asarray(r), 1.345,
                                                                      group_size)),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(float(t_robust.huber_cost(T(r), 1.345, group_size)),
                               float(j_robust.huber_cost(jnp.asarray(r), 1.345, group_size)),
                               rtol=1e-14)


def test_mask_and_solve_damped(rng):
    A = rng.normal(size=(40, 12))
    H = A.T @ A * np.logspace(0, 4, 12)[:, None] * np.logspace(0, 4, 12)[None, :]
    g = rng.normal(size=12)
    mask = np.ones(12)
    mask[[2, 7]] = 0.0
    Hj, gj = j_lm._mask_system(jnp.asarray(H), jnp.asarray(g), jnp.asarray(mask))
    Ht, gt = t_lm._mask_system(T(H), T(g), T(mask))
    np.testing.assert_array_equal(Ht.numpy(), np.asarray(Hj))
    for lam in (0.0, 1e-4, 10.0):
        want = np.asarray(j_lm._solve_damped(Hj, gj, lam))
        got = t_lm._solve_damped(Ht, gt, lam).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    # A factorization failure gives NaN (the LM step is then rejected).
    assert np.isnan(t_lm._solve_damped(-Ht, gt, 0.0).numpy()).all()


def _problem(rng):
    pts = rng.normal(size=(30, 3))
    q_true = np.asarray(j_lie.so3_exp(jnp.asarray([0.3, -1.1, 2.0])))
    y = (np.asarray(j_lie.quat_rotate(jnp.asarray(q_true), jnp.asarray(pts))) * 1.3
         + [0.5, -0.2, 1.0] + rng.normal(size=pts.shape) * 0.01)
    y[:3] += 2.0  # outliers for the Huber weights
    q0 = np.asarray(j_lie.so3_exp(jnp.asarray([2.5, 0.0, 0.0])))
    params0 = {"q": q0, "t": np.zeros(3), "s": np.array([0.0, 0.4])}
    return pts, y, params0


def _make(L, B, R, xp, pts, y, ls):
    """(linearize, cost, retract, layout) for framework ``xp`` ("jax"/"torch")."""
    layout = B.BlockLayout([B.BlockSpec("q", (4,), "quat"), B.BlockSpec("t", (3,)),
                            B.BlockSpec("s", (2,))])
    if xp == "jax":
        A, jac = jnp.asarray, jax.jacfwd
        P, Y = A(pts), A(y)
        zeros = lambda n: jnp.zeros((n,))  # noqa: E731
        stop = jax.lax.stop_gradient
    else:
        A, jac = T, torch.func.jacfwd
        P, Y = T(pts), T(y)
        zeros = lambda n: torch.zeros(n, dtype=torch.float64)  # noqa: E731
        stop = lambda x: x.detach()  # noqa: E731

    def residual(prm):
        pred = L.quat_rotate(prm["q"], P) * (1.0 + prm["s"][0]) + prm["t"]
        r = (pred - Y).reshape(-1)
        return r, prm["s"][1:] ** 2 - 0.1

    def linearize(prm):
        r, r2 = residual(prm)
        w = stop(R.huber_sqrt_weights(r, ls, group_size=3))

        def f(d):
            rr, rr2 = residual(layout.retract(prm, d))
            return (rr * w, rr2)

        Jr, J2 = jac(f)(zeros(layout.tangent_dim))
        rw = r * w
        H = Jr.T @ Jr + J2.T @ J2
        gvec = Jr.T @ rw + J2.T @ r2
        cost = R.huber_cost(r, ls, group_size=3) + 0.5 * (r2 ** 2).sum()
        return H, gvec, cost

    def cost(prm):
        r, r2 = residual(prm)
        return R.huber_cost(r, ls, group_size=3) + 0.5 * (r2 ** 2).sum()

    return linearize, cost, layout


@pytest.mark.parametrize("strategy", ["classic", "fused"])
def test_lm_iterations_status_and_history_match(strategy, rng):
    pts, y, params0 = _problem(rng)
    cfg_kw = dict(max_iters=40, ftol=1e-10, history_len=48)
    jlin, jcost, jlay = _make(j_lie, j_blocks, j_robust, "jax", pts, y, 0.5)
    tlin, tcost, tlay = _make(t_lie, t_blocks, t_robust, "torch", pts, y, 0.5)
    fixed = ["s"] if strategy == "classic" else []
    jres = jax.jit(lambda p0: j_lm.lm_optimize(
        jlin, jcost, jlay.retract, p0, jlay.free_mask(fixed), j_lm.LMConfig(**cfg_kw),
        strategy=strategy))({k: jnp.asarray(v) for k, v in params0.items()})
    tres = t_lm.lm_optimize(tlin, tcost, tlay.retract, {k: T(v) for k, v in params0.items()},
                            tlay.free_mask(fixed), t_lm.LMConfig(**cfg_kw), strategy=strategy)
    assert int(tres.iterations) == int(jres.iterations) > 3
    assert int(tres.status) == int(jres.status)
    assert bool(tres.converged) == bool(jres.converged)
    jh, th = np.asarray(jres.cost_history), tres.cost_history.numpy()
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    np.testing.assert_allclose(th[~np.isnan(th)], jh[~np.isnan(jh)], rtol=1e-9)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-9)
    np.testing.assert_allclose(float(tres.lam), float(jres.lam), rtol=1e-6)
    for k in params0:
        np.testing.assert_allclose(tres.params[k].numpy(), np.asarray(jres.params[k]),
                                   rtol=1e-8, atol=1e-10)
    assert tres.linearizations == int(tres.iterations) + (strategy == "fused")
