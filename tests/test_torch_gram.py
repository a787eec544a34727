"""Port parity: solver/gram.py, the fused densify + Gram step (kernel K1).

The plain version (the CPU path of ``gram.fused_gram``) is held against
the JAX package's ``_densify_segments`` + Gram and against its Pallas
kernel ``pallas_gram.make_fused_gram`` run in interpret mode, mirroring
the cases of tests/test_pallas_gram.py: a unit case, a row count that is
not a multiple of the Pallas tile, batched chunks, the inputs the full
linearizer hands the kernel, plus a board-point run segment. Inputs are
float32 (the kernel's type); tolerance rtol 1e-5 / atol 1e-4, the standard
of tests/test_pallas_gram.py (equality up to float32 rounding of the
summation order).

The hand-written CUDA kernel is held against the plain version on the card
by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.solver import gram
from openimucameracalibrator_tpu.core import spline_estimator as jse
from openimucameracalibrator_tpu.solver import pallas_gram

TOL = dict(rtol=1e-5, atol=1e-4)


def _random_problem(rng, C=37, rd=2, ws=9, wr=5, n_fixed=8, n_points=0):
    """Compact J (C, rd, F), r, per-measurement run indices and the
    kernel-form segments, laid out like the reprojection family."""
    order = 4
    F = 3 * order + 6 + 3 * order + n_fixed + 3 * (n_points > 0)
    col_r = 3 * order + 6
    col_f = col_r + 3 * order
    J = rng.normal(size=(C, rd, F)).astype(np.float32)
    r = rng.normal(size=(C * rd,)).astype(np.float32)
    runs = [rng.integers(0, ws - order + 1, size=C), rng.integers(0, wr - order + 1, size=C)]
    segs = [("run", 0, order, 3, ws, 0), ("run", col_r, order, 3, wr, 3 * ws),
            ("fixed", col_f, n_fixed, 3 * ws + 3 * wr)]
    L = 3 * ws + 3 * wr + n_fixed
    if n_points:
        runs.append(rng.integers(0, n_points, size=C))
        segs.append(("run", col_f + n_fixed, 1, 3, n_points, L))
        L += 3 * n_points
    return J, r, [np.asarray(i, np.int32) for i in runs], tuple(segs), L


def _jax_densify_gram(J, r, runs, segs, L):
    """The JAX package's _densify_segments (per-measurement indices) + Gram."""
    jsegs, it = [], iter(runs)
    for s in segs:
        if s[0] == "run":
            jsegs.append(("run", s[1], s[2], s[3], jnp.asarray(next(it)), s[4]))
        else:
            jsegs.append(("fixed", s[1], s[2]))
    Jd, rf = jse._densify_segments(jnp.asarray(r), jnp.asarray(J), jsegs, L)
    return np.asarray(Jd.T @ Jd), np.asarray(Jd.T @ rf)


def _port(J, r, runs, segs, L):
    """The port's wrapper on CPU tensors: (K=1) kernel-form inputs."""
    C, rd, F = J.shape
    idx = torch.as_tensor(np.stack([np.repeat(i, rd) for i in runs])[:, None, :])
    H, g = gram.fused_gram(torch.as_tensor(J.reshape(1, C * rd, F)),
                           torch.as_tensor(r.reshape(1, C * rd)), idx, segs, L)
    return H[0].numpy(), g[0].numpy()


def _pallas(J, r, runs, segs, L, tile_rows):
    C, rd, F = J.shape
    fused = pallas_gram.make_fused_gram(segs, L, C * rd, F, tile_rows=tile_rows, interpret=True)
    H, g = fused(jnp.asarray(J.reshape(C * rd, F)), jnp.asarray(r),
                 *[jnp.asarray(np.repeat(i, rd)) for i in runs])
    return np.asarray(H), np.asarray(g)


@pytest.mark.parametrize("case", ["unit", "ragged_rows", "board_points"])
def test_plain_matches_densify_gram_and_pallas(case, rng):
    kw = {"unit": {}, "ragged_rows": dict(C=11), "board_points": dict(C=19, n_points=6)}[case]
    tile = {"unit": 32, "ragged_rows": 16, "board_points": 16}[case]
    J, r, runs, segs, L = _random_problem(rng, **kw)
    H, g = _port(J, r, runs, segs, L)
    for H_ref, g_ref in (_jax_densify_gram(J, r, runs, segs, L),
                         _pallas(J, r, runs, segs, L, tile)):
        np.testing.assert_allclose(H, H_ref, **TOL)
        np.testing.assert_allclose(g, g_ref, **TOL)


def test_plain_batched_chunks_match_vmapped_pallas(rng):
    """The chunk axis of the port's (K, R, F) inputs against the Pallas
    kernel vmapped over chunks (how the JAX linearizer integrates it)."""
    K = 3
    packs = [_random_problem(rng, C=24) for _ in range(K)]
    _, _, _, segs, L = packs[0]
    C, rd, F = packs[0][0].shape
    Js = np.stack([p[0].reshape(C * rd, F) for p in packs])
    rs = np.stack([p[1] for p in packs])
    idx = np.stack([np.stack([np.repeat(i, rd) for i in p[2]]) for p in packs], axis=1)
    H, g = gram.fused_gram(torch.as_tensor(Js), torch.as_tensor(rs), torch.as_tensor(idx),
                           segs, L)
    fused = pallas_gram.make_fused_gram(segs, L, C * rd, F, tile_rows=16, interpret=True)
    Hb, gb = jax.vmap(fused)(jnp.asarray(Js), jnp.asarray(rs), *map(jnp.asarray, idx))
    np.testing.assert_allclose(H.numpy(), np.asarray(Hb), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gb), **TOL)


def test_linearizer_inputs_match_pallas(monkeypatch):
    """Every fused_gram call the port's fast linearizer makes on the tiny
    spline problem (reprojection, accelerometer, gyroscope) gives what the
    Pallas kernel gives on the same inputs."""
    import __graft_entry__ as ge

    from openimucameracalibrator_torch.core import spline_estimator as tse
    from openimucameracalibrator_torch.utils import convert

    p, params = ge._tiny_problem(jnp.float32)
    tp = convert.problem_from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in p._asdict().items()},
        device="cpu", dtype=torch.float32)
    tparams = convert.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                        device="cpu", dtype=torch.float32)
    calls = []
    real = gram.fused_gram

    def spy(J, r, idx, segs, L, tag=None):
        out = real(J, r, idx, segs, L, tag=tag)
        calls.append((tag, J.numpy(), r.numpy(), idx.numpy(), segs, L, out))
        return out

    monkeypatch.setattr(gram, "fused_gram", spy)
    plans, arrs = tse.plan_fast_assembly(tp, obs_chunk=64, imu_chunk=32)
    tse.make_fast_linearizer(tp, tse.build_layout(tp), plans)(tparams, arrs)
    assert sorted(c[0] for c in calls) == ["accel", "gyro", "obs"]
    for tag, J, r, idx, segs, L, (H, g) in calls:
        K, R, F = J.shape
        fused = pallas_gram.make_fused_gram(segs, L, R, F, tile_rows=64, interpret=True)
        Hp, gp = jax.vmap(fused)(jnp.asarray(J), jnp.asarray(r), *map(jnp.asarray, idx))
        scale = np.abs(np.asarray(Hp)).max()
        np.testing.assert_allclose(H.numpy(), np.asarray(Hp), rtol=1e-5, atol=1e-6 * scale)
        np.testing.assert_allclose(g.numpy(), np.asarray(gp), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(gp)).max())


def _reached(tab, lo, hi):
    """The skip rule of csrc/gram.cu for one (row tile, H tile): rows whose
    run-q indices lie in [lo[q], hi[q]] can reach the tile."""
    n_run = len(lo)
    return bool(tab[-1]) or any(max(lo[q], tab[2 * q]) <= min(hi[q], tab[2 * q + 1])
                                for q in range(n_run))


@pytest.mark.parametrize("layout", ["obs", "board_points", "accel", "tile_16"])
def test_tile_reach_table_matches_densified_rows(layout, rng):
    """gram._tile_reach against the densified D (numpy, J all ones): a
    single row reaches an H tile exactly when D has a nonzero in the tile's
    columns, for in-range and out-of-range indices; over a 64-row tile
    (min and max of each run's indices) the rule never skips a tile that
    one of its rows reaches."""
    tile = 16 if layout == "tile_16" else 32
    order = 4
    if layout == "accel":
        ws, wr, nb = 12, 9, 6
        segs = (("run", 0, order, 3, ws, 0), ("run", 18, order, 3, wr, 3 * ws),
                ("run", 36, 2, 3, nb, 3 * ws + 3 * wr), ("fixed", 42, 9, 3 * (ws + wr + nb)))
        F, L = 51, 3 * (ws + wr + nb) + 9
    else:
        J, _, _, segs, L = _random_problem(rng, n_points=6 if layout == "board_points" else 0)
        F = J.shape[-1]
    runs = [s for s in segs if s[0] == "run"]
    R = 300
    idx = np.stack([rng.integers(-2, s[4] + 2, size=R) for s in runs]).astype(np.int32)
    D, _ = gram._densify_segments(torch.zeros(1, R, 1), torch.ones(1, R, 1, F),
                                  gram._per_row_segments(segs, torch.as_tensor(idx[:, None])), L)
    nz = D[0].numpy() != 0
    max_run = 4  # MAX_RUN of csrc/gram.cu
    tab = gram._tile_reach(segs, L, tile, max_run)
    assert tab.shape == (-(-L // tile), 2 * max_run + 1)
    for t in range(tab.shape[0]):
        cols = nz[:, t * tile:(t + 1) * tile]
        for row in range(R):
            assert _reached(tab[t], idx[:, row], idx[:, row]) == cols[row].any(), (t, row)
        for r0 in range(0, R, 64):
            blk = idx[:, r0:r0 + 64]
            if cols[r0:r0 + 64].any():
                assert _reached(tab[t], blk.min(1), blk.max(1))


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    """A CUDA call is checked before launch; CPU tensors take the plain
    version without any check of type (float64 works there)."""
    J, r, runs, segs, L = _random_problem(rng, C=5)
    H, _ = _port(J.astype(np.float64), r.astype(np.float64), runs, segs, L)
    assert H.dtype == np.float64
    with pytest.raises(ValueError):
        gram.fused_gram(torch.zeros(1, 2, 3, device="meta"), torch.zeros(1, 2, device="meta"),
                        torch.zeros(2, 1, 2, dtype=torch.int32, device="meta"), segs, L)
