"""Port parity: parallel/sharded.py and parallel/schur.py.

On ``__graft_entry__._tiny_problem(float64)``, with n=8 shards in one
process on the CPU (the JAX package runs its own on the conftest's 8
virtual CPU devices):

* the sharded normal equations equal the JAX package's
  ``make_sharded_fast_solver_functions`` and the port's single-device
  linearizer (1e-10 of the largest entry); the scatter reference path too;
* ``_pad_family``, ``_effective_chunk``, ``_plan_family`` and
  ``partition_knots`` give the JAX package's arrays; padding is neutral;
* the knot-sharded Schur step equals the dense damped step, with and
  without the board-point prior, and the separator does not grow with P.

The LM-level comparisons, slow in the JAX package's tests, are slow here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from openimucameracalibrator_torch.core import spline_estimator as tse
from openimucameracalibrator_torch.parallel import schur as t_schur
from openimucameracalibrator_torch.parallel import sharded as t_sharded
from openimucameracalibrator_torch.solver import lm as t_lm
from openimucameracalibrator_torch.utils import convert
from openimucameracalibrator_tpu.parallel import schur as j_schur
from openimucameracalibrator_tpu.parallel import sharded as j_sharded

CHUNKS = dict(obs_chunk=128, imu_chunk=32)
FLAGS = tse.DEFAULT_FLAGS | {tse.CAM_LINE_DELAY, tse.TIME_OFFSET}


def _fields(p):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in p._asdict().items()}


@pytest.fixture(scope="module")
def tiny():
    p, params = ge._tiny_problem(jnp.float64)
    tp = convert.problem_from_numpy(_fields(p), device="cpu")
    tparams = convert.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                        device="cpu")
    return p, params, tp, tparams


@pytest.fixture(scope="module")
def single(tiny):
    """The port's single-device (H, g, cost) and cost at the initial point."""
    _, _, tp, tparams = tiny
    lin, cost = tse.make_solver_functions_fast(tp, tse.build_layout(tp), **CHUNKS)
    return lin(tparams), float(cost(tparams))


def _close(got, want, tol=1e-10):
    for a, b in zip(got[:2], want[:2]):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=tol)


def test_sharded_normal_equations_match_jax_and_single_device(tiny, single):
    p, params, tp, tparams = tiny
    mesh = t_sharded.make_mesh(8, device="cpu")
    lin, cost, layout = t_sharded.make_sharded_fast_solver_functions(tp, mesh, **CHUNKS)
    got = lin(tparams)
    _close(got, single[0])
    np.testing.assert_allclose(float(cost(tparams)), single[1], rtol=1e-12)
    j_lin, _, _ = j_sharded.make_sharded_fast_solver_functions(p, j_sharded.make_mesh(8),
                                                               **CHUNKS)
    _close(got, [np.asarray(x) for x in jax.jit(j_lin)(params)])


def test_sharded_scatter_reference_path(tiny, single):
    _, _, tp, tparams = tiny
    lin, _, _ = t_sharded.make_sharded_solver_functions(tp, t_sharded.make_mesh(8, device="cpu"))
    _close(lin(tparams), single[0])


def test_sharded_padding_is_neutral(tiny):
    _, _, tp, tparams = tiny
    layout = tse.build_layout(tp)
    H0, g0, c0 = tse.make_solver_functions(tp, layout)[0](tparams)
    H1, g1, c1 = tse.make_solver_functions(t_sharded.pad_problem(tp, 7), layout)[0](tparams)
    np.testing.assert_allclose(H1.numpy(), H0.numpy(), rtol=0, atol=1e-12 * H0.abs().max())
    np.testing.assert_allclose(float(c1), float(c0), rtol=1e-12)


@pytest.mark.parametrize("m, n, chunk", [(1200, 8, 2048), (100, 8, 32), (240, 3, 64),
                                         (7, 8, 128)])
def test_pad_family_and_effective_chunk_match_jax(m, n, chunk):
    rng = np.random.default_rng(m)
    arrs = {"t": np.sort(rng.uniform(0.0, 12.0, m)), "v": rng.uniform(size=m) > 0.1,
            "x": rng.normal(size=(m, 3))}
    got, k = t_sharded._pad_family(arrs, "t", "v", n, chunk)
    want, kj = j_sharded._pad_family(arrs, "t", "v", n, chunk)
    assert k == kj and set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for q in (128, 256):
        assert (t_sharded._effective_chunk(m, n, chunk, quantum=q)
                == j_sharded._effective_chunk(m, n, chunk, quantum=q))


def _schur_plans(mod, p, n):
    """_plan_family of the three families, as make_schur_solver_functions
    computes them, for either package."""
    fam_o, _ = mod._pad_family(_fields_np(p, ("obs_t", "obs_valid")), "obs_t", "obs_valid",
                               n, 256)
    fam_a, _ = mod._pad_family(_fields_np(p, ("accel_t", "accel_valid")), "accel_t",
                               "accel_valid", n, 128)
    fam_g, _ = mod._pad_family(_fields_np(p, ("gyro_t", "gyro_valid")), "gyro_t",
                               "gyro_valid", n, 128)
    return (mod._plan_family(fam_o["obs_t"], p, 256, True),
            mod._plan_family(fam_a["accel_t"], p, 128, True),
            mod._plan_family(fam_g["gyro_t"], p, 128, False))


def _fields_np(p, keys):
    return {k: np.asarray(getattr(p, k).numpy() if isinstance(getattr(p, k), torch.Tensor)
                          else getattr(p, k)) for k in keys}


def test_partition_matches_jax(tiny):
    """Chunk plans and the knot partition equal the JAX package's on the
    same shards."""
    p, _, tp, _ = tiny
    n = 8
    tpl, jpl = _schur_plans(t_sharded, tp, n), _schur_plans(j_sharded, p, n)
    for a, b in zip(tpl, jpl):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    _, _, _, _, part = t_schur.make_schur_solver_functions(tp, t_sharded.make_mesh(
        n, device="cpu"), **CHUNKS)
    _, _, _, _, jpart = j_schur.make_schur_solver_functions(p, j_sharded.make_mesh(n),
                                                            **CHUNKS)
    for f in ("n", "m", "S", "n_s_loc", "n_r_loc"):
        assert getattr(part, f) == getattr(jpart, f), f
    for f in ("s_lo", "r_lo", "loc2glob", "int_mask", "loc2shared", "shared2glob"):
        np.testing.assert_array_equal(getattr(part, f), getattr(jpart, f), err_msg=f)
    assert [s.name for s in part.layout_loc.specs] == [s.name for s in jpart.layout_loc.specs]


def _dense_step(tp, tparams, flags, lam):
    layout = tse.build_layout(tp)
    H, g, c = tse.make_solver_functions(tp, layout)[0](tparams)
    mask = layout.free_mask(fixed=tse.flags_to_fixed(flags))
    Hm, gm = t_lm._mask_system(H, g, mask)
    return t_lm._solve_damped(Hm, gm, lam) * mask, mask, float(c)


@pytest.mark.parametrize("points", ["no points", "points + prior"])
def test_schur_solve_matches_dense(tiny, points):
    """One linearize + damped solve: the knot-sharded Schur step equals the
    dense Jacobi-equilibrated Cholesky step."""
    _, _, tp, tparams = tiny
    flags, n = FLAGS, 8
    if points == "points + prior":
        rng = np.random.default_rng(2)
        pts = rng.uniform(0.0, 0.3, (40, 3)) * [1, 1, 0]
        ids = rng.integers(0, 40, int(tp.obs_t.shape[0]))
        tp = tse.enable_board_points(tp._replace(obs_pt=torch.as_tensor(pts[ids])),
                                     board_points=pts, obs_pt_id=ids, point_prior_std=1e-3)
        tparams = dict(tparams, points=tp.pt_prior_mean.clone())
        flags, n = FLAGS | {tse.POINTS}, 4
    lin, cost, solve, _, part = t_schur.make_schur_solver_functions(
        tp, t_sharded.make_mesh(n, device="cpu"), **CHUNKS)
    NE, _, c1 = lin(tparams)
    assert NE.C.shape == (part.S, part.S) and NE.H_loc.shape == (n, part.m, part.m)
    for lam in (1e-4, 1e-1, 10.0):
        want, mask, c0 = _dense_step(tp, tparams, flags, lam)
        got = solve(NE, None, lam, mask)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-9 * want.abs().max().item())
    np.testing.assert_allclose(float(c1), c0, rtol=1e-10)
    np.testing.assert_allclose(float(cost(tparams)), c0, rtol=1e-10)


def test_separator_independent_of_points(tiny):
    """Board points are a bordered third level, not separator coordinates:
    S is the same with 0 and 60 points, and only the local tail widens."""
    _, _, tp, _ = tiny
    mesh = t_sharded.make_mesh(4, device="cpu")
    _, _, _, _, part0 = t_schur.make_schur_solver_functions(tp, mesh, **CHUNKS)
    P = 60
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.0, 0.3, (P, 3)) * [1, 1, 0]
    ids = rng.integers(0, P, int(tp.obs_t.shape[0]))
    pe = tse.enable_board_points(tp._replace(obs_pt=torch.as_tensor(pts[ids])),
                                 board_points=pts, obs_pt_id=ids)
    _, _, _, _, partP = t_schur.make_schur_solver_functions(pe, mesh, **CHUNKS)
    assert partP.S == part0.S
    assert partP.m == part0.m + 3 * P


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["sharded", "schur"])
def test_lm_matches_single_device(tiny, solver):
    _, _, tp, tparams = tiny
    cfg = t_lm.LMConfig(max_iters=3, ftol=0.0)
    ref = tse.optimize(tp, tparams, FLAGS, config=cfg, method="fast")
    mesh = t_sharded.make_mesh(4, device="cpu")
    if solver == "sharded":
        res = t_sharded.optimize_sharded(tp, tparams, mesh, FLAGS, config=cfg, **CHUNKS)
    else:
        res = t_schur.optimize_schur(tp, tparams, mesh, FLAGS, config=cfg, **CHUNKS)
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-9)
    for k, v in ref.params.items():
        np.testing.assert_allclose(res.params[k].numpy(), v.numpy(), rtol=0, atol=1e-8,
                                   err_msg=k)
