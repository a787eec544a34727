"""Port parity: solver/banded.py and its wiring in make_solve_fn.

On the problems of tests/test_banded.py (float64, CPU), the port's slab
structure is the JAX package's (same idx, valid, tail), and the port's
banded damped solve equals the JAX banded solve and the port's dense
``lm._solve_damped`` on the same (H, g, lambda) to 1e-10 norm-wise
relative (||a - b|| / ||b||). At lambda = 1e-6 the equilibrated system's
condition number is ~3.6e6, so float64 guarantees no more than
~cond * eps = 8e-10 per entry: there the JAX package's own dense and
banded steps differ by 5e-11 of the largest entry, the port's by 1.3e-10.
``optimize`` through the banded solve follows the dense one; a short
problem has no decomposition ("auto" falls back to dense, "banded" raises
ValueError, as in the JAX package); a matrix that is not positive
definite gives NaNs, not an exception.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.core import spline_estimator as tse
from openimucameracalibrator_torch.solver import banded as t_banded
from openimucameracalibrator_torch.solver import lm as t_lm
from openimucameracalibrator_torch.utils import convert
from openimucameracalibrator_tpu.core import spline_estimator as jse
from openimucameracalibrator_tpu.solver import banded as j_banded
from test_banded import _problem

REL = 1e-10

SIZES = {"default": {}, "optimize": dict(mo=360, ma=200), "short": dict(dur=2.0, ma=60, mo=120)}


def _port(p, params):
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in p._asdict().items()}
    tp = convert.problem_from_numpy(fields, device="cpu")
    tparams = convert.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                        device="cpu")
    return tp, tparams


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, kw in SIZES.items():
        p, params = _problem(**kw)
        out[name] = (p, params) + _port(p, params)
    return out


@pytest.mark.parametrize("size", list(SIZES))
def test_structure_matches_jax(problems, size):
    p, _, tp, _ = problems[size]
    jstruct = j_banded.from_problem(jse.build_layout(p), p, jse.ORDER)
    layout = tse.build_layout(tp)
    tstruct = t_banded.from_problem(layout, tp, tse.ORDER)
    assert (jstruct is None) == (tstruct is None) == (size == "short")
    if tstruct is None:
        return
    for f in ("idx", "valid", "tail"):
        np.testing.assert_array_equal(getattr(tstruct, f), np.asarray(getattr(jstruct, f)))
    assert tstruct.tangent_dim == jstruct.tangent_dim == layout.tangent_dim


@pytest.fixture(scope="module")
def masked_system(problems):
    _, _, tp, tparams = problems["default"]
    layout = tse.build_layout(tp)
    H, g, _ = tse.make_solver_functions(tp, layout)[0](tparams)
    mask = layout.free_mask(fixed=tse.flags_to_fixed(tse.DEFAULT_FLAGS | {tse.CAM_LINE_DELAY}),
                            dtype=H.dtype, device="cpu")
    Hm, gm = t_lm._mask_system(H, g, mask)
    return tp, layout, Hm, gm


@pytest.mark.parametrize("lam", [1e-6, 1e-3, 1.0])
def test_banded_solve_matches_jax_and_dense(masked_system, lam):
    tp, layout, Hm, gm = masked_system
    struct = t_banded.from_problem(layout, tp, tse.ORDER)
    d_band = t_banded.make_banded_solver(struct)(Hm, gm, torch.tensor(lam, dtype=Hm.dtype))
    d_dense = t_lm._solve_damped(Hm, gm, torch.tensor(lam, dtype=Hm.dtype))
    jsolve = jax.jit(j_banded.make_banded_solver(
        j_banded.SlabStructure(jnp.asarray(struct.idx), jnp.asarray(struct.valid),
                               jnp.asarray(struct.tail), struct.tangent_dim)))
    d_jax = np.asarray(jsolve(jnp.asarray(Hm.numpy()), jnp.asarray(gm.numpy()), lam))
    d_band, d_dense = d_band.numpy(), d_dense.numpy()
    for other in (d_dense, d_jax):
        assert np.linalg.norm(d_band - other) <= REL * np.linalg.norm(other)


def test_optimize_banded_matches_dense(problems):
    _, _, tp, tparams = problems["optimize"]
    layout = tse.build_layout(tp)
    assert t_banded.from_problem(layout, tp, tse.ORDER) is not None
    # "auto" picks dense below BANDED_MIN_DIM; force the banded path.
    assert tse.make_solve_fn(tp, layout, "auto") is None
    cfg = t_lm.LMConfig(max_iters=3, ftol=0.0)
    r_band = tse.optimize(tp, tparams, config=cfg, method="scatter", solver="banded")
    r_dense = tse.optimize(tp, tparams, config=cfg, method="scatter", solver="dense")
    assert (r_band.iterations, r_band.status) == (r_dense.iterations, r_dense.status)
    np.testing.assert_allclose(float(r_band.cost), float(r_dense.cost), rtol=REL)
    for k in ("q_so3", "t_r3", "gravity", "bias_a", "bias_g"):
        np.testing.assert_allclose(r_band.params[k].numpy(), r_dense.params[k].numpy(),
                                   rtol=0, atol=1e-9)


def test_short_problem_falls_back_to_dense(problems):
    _, _, tp, _ = problems["short"]
    layout = tse.build_layout(tp)
    assert t_banded.from_problem(layout, tp, tse.ORDER) is None
    assert tse.make_solve_fn(tp, layout, "auto") is None
    assert tse.make_solve_fn(tp, layout, "auto", banded_min_dim=10) is None
    with pytest.raises(ValueError, match="slab decomposition"):
        tse.make_solve_fn(tp, layout, "banded")


def test_auto_takes_banded_from_banded_min_dim(masked_system):
    tp, layout, Hm, gm = masked_system
    D = layout.tangent_dim
    assert tse.make_solve_fn(tp, layout, "auto", banded_min_dim=D + 1) is None
    assert tse.make_solve_fn(tp, layout, "dense", banded_min_dim=10) is None
    solve = tse.make_solve_fn(tp, layout, "auto", banded_min_dim=D)
    assert solve is not None
    lam = torch.tensor(1e-3, dtype=Hm.dtype)
    want = t_banded.make_banded_solver(t_banded.from_problem(layout, tp, tse.ORDER))(Hm, gm, lam)
    np.testing.assert_array_equal(solve(Hm, gm, lam).numpy(), want.numpy())
    with pytest.raises(ValueError, match="unknown solver"):
        tse.make_solve_fn(tp, layout, "sparse")


def test_not_positive_definite_gives_nan(masked_system):
    tp, layout, Hm, gm = masked_system
    solve = t_banded.make_banded_solver(t_banded.from_problem(layout, tp, tse.ORDER))
    bad = Hm.clone()
    bad[5, 5] = -1.0  # an indefinite slab block after Jacobi scaling
    d = solve(bad, gm, torch.tensor(0.0, dtype=Hm.dtype))
    assert d.shape == gm.shape and bool(torch.isnan(d).any())
