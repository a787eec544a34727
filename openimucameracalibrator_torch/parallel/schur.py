"""Knot-segment model parallelism: distributed Schur-complement solver.

Port of ``parallel/schur.py`` of the JAX package, on ``torch.distributed``.
The data-parallel solver (``parallel/sharded.py``) replicates the dense
D x D normal equations; this module shards the spline-knot axis:

* Measurements are split into contiguous TIME shards (they are sorted), so
  each shard's residuals touch only a local window of SO(3)/R³ knots (every
  residual covers ORDER = 6 contiguous knots).
* Each shard assembles a LOCAL dense Hessian over [its knot window + the
  small global tail (biases, gravity, T_i_c, line delay, time offset, IMU
  intrinsics, board points)] with the fast chunk linearizer (knot-window
  origins ``s_org`` / ``r_org``; the fused Gram kernel on the card): the
  full D x D matrix is never formed.
* Knots touched by more than one shard (the halo) plus the tail form the
  SEPARATOR system. Interior knots are eliminated per shard with a local
  Cholesky (one batched factorization over the shards a process holds);
  the reduced Schur complement is summed over the shards and all-reduced
  across processes, solved replicated, and back-substituted per shard.

Algebraically exact (equal to the replicated dense solve up to rounding),
with per-shard Hessian memory O((D/n + S)²) instead of O(D²). Board points
form a BORDERED third level, not part of the separator: each observation
touches exactly one point, so the point block is eliminated after the
separator reduction and S is independent of the point count P.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from openimucameracalibrator_torch.core import spline_estimator as se
from openimucameracalibrator_torch.parallel.sharded import (Mesh, _cost_of, _local_arrays,
                                                            _plan_family, _shard_families,
                                                            _sum_shards, all_reduce,
                                                            gather_objects, world_size)
from openimucameracalibrator_torch.solver import blocks, lm


class KnotPartition(NamedTuple):
    """Host-computed static partition of the knot axis over n shards."""

    n: int                      # shard count
    m: int                      # local tangent dim (shared across shards)
    S: int                      # separator (shared) tangent dim
    n_s_loc: int                # local so3 knot-window size
    n_r_loc: int                # local r3 knot-window size
    s_lo: np.ndarray            # (n,) first so3 knot of each shard window
    r_lo: np.ndarray            # (n,)
    loc2glob: np.ndarray        # (n, m) global tangent index of local coord
    int_mask: np.ndarray        # (n, m) 1.0 where coord is interior to d
    loc2shared: np.ndarray      # (n, m) separator index, S where interior
    shared2glob: np.ndarray     # (S,) global tangent index of separator coord
    layout_loc: blocks.BlockLayout  # local block layout


def _touched_range(times, valid, t0, dt, n_knots, order):
    t = np.asarray(times).reshape(-1)[np.asarray(valid).reshape(-1)]
    if t.size == 0:
        return None
    i = np.clip(np.floor((t - t0) / dt), 0, n_knots - order).astype(np.int64)
    return int(i.min()), int(i.max()) + order


def partition_knots(p: se.SplineProblem, n: int, plans_np) -> KnotPartition:
    """Build the static knot partition from per-shard chunk plans.

    ``plans_np``: ((ws_o, wr_o, sb_o, rb_o), (ws_a, wr_a, sb_a, rb_a),
    (ws_g, _, sb_g, _), touched) as produced in
    :func:`make_schur_solver_functions`.
    """
    (ws_o, wr_o, sb_o, rb_o), (ws_a, wr_a, sb_a, rb_a), (ws_g, _, sb_g, _), touched = plans_np

    # Shard knot-coverage windows: union of all chunk windows.
    lo_s = np.minimum.reduce([sb_o.min(1), sb_a.min(1), sb_g.min(1)])
    hi_s = np.maximum.reduce([sb_o.max(1) + ws_o, sb_a.max(1) + ws_a, sb_g.max(1) + ws_g])
    lo_r = np.minimum(rb_o.min(1), rb_a.min(1))
    hi_r = np.maximum(rb_o.max(1) + wr_o, rb_a.max(1) + wr_a)
    n_s_loc = min(int((hi_s - lo_s).max()), p.n_so3)
    n_r_loc = min(int((hi_r - lo_r).max()), p.n_r3)
    s_lo = np.clip(lo_s, 0, p.n_so3 - n_s_loc).astype(np.int32)
    r_lo = np.clip(lo_r, 0, p.n_r3 - n_r_loc).astype(np.int32)

    # Ownership from exact touched ranges: knots touched by one shard are
    # its interior; touched by >=2 are separator; untouched knots inside a
    # coverage window go to the lowest covering shard (their rows are zero,
    # so the assignment only keeps the local factorization square).
    def ownership(n_knots, tr, lo, width):
        count = np.zeros(n_knots, np.int32)
        owner = np.full(n_knots, -1, np.int32)
        for d in range(n):
            if tr[d] is None:
                continue
            a, b = tr[d]
            count[a:b] += 1
            owner[a:b] = np.where(count[a:b] == 1, d, owner[a:b])
        shared = count >= 2
        for d in range(n - 1, -1, -1):  # lowest shard wins
            cov = slice(int(lo[d]), int(lo[d]) + width)
            sel = (count[cov] == 0)
            owner[cov] = np.where(sel, d, owner[cov])
        return owner, shared

    own_s, sh_s = ownership(p.n_so3, [t[0] for t in touched], s_lo, n_s_loc)
    own_r, sh_r = ownership(p.n_r3, [t[1] for t in touched], r_lo, n_r_loc)

    layout_g = se.build_layout(p)
    tail_specs = [s for s in layout_g.specs if s.name not in ("q_so3", "t_r3")]
    tail_dim = sum(s.tangent_size for s in tail_specs)
    # Board points are NOT part of the separator: they live in a bordered
    # third level solved after the separator reduction, so S is independent
    # of P. They stay in layout_loc (local assembly needs the knot-point
    # coupling columns).
    pts_dim = 3 * p.n_points
    tail_dim_sep = tail_dim - pts_dim
    off_r3_g = layout_g.offsets["t_r3"]
    off_tail_g = layout_g.offsets["bias_a"]

    sh_s_idx = np.flatnonzero(sh_s)
    sh_r_idx = np.flatnonzero(sh_r)
    n_sh_s, n_sh_r = len(sh_s_idx), len(sh_r_idx)
    S = 3 * (n_sh_s + n_sh_r) + tail_dim_sep
    # knot -> separator slot (first coord of its 3), -1 if not shared
    s_slot = np.full(p.n_so3, -1, np.int64)
    s_slot[sh_s_idx] = 3 * np.arange(n_sh_s)
    r_slot = np.full(p.n_r3, -1, np.int64)
    r_slot[sh_r_idx] = 3 * n_sh_s + 3 * np.arange(n_sh_r)
    shared2glob = np.concatenate([
        (3 * sh_s_idx[:, None] + np.arange(3)).reshape(-1),
        (off_r3_g + 3 * sh_r_idx[:, None] + np.arange(3)).reshape(-1),
        off_tail_g + np.arange(tail_dim_sep),
    ]).astype(np.int32)

    layout_loc = blocks.BlockLayout(
        [blocks.BlockSpec("q_so3", (n_s_loc, 4), "quat"),
         blocks.BlockSpec("t_r3", (n_r_loc, 3))] + list(tail_specs))
    m = layout_loc.tangent_dim
    tail0 = 3 * (n_s_loc + n_r_loc)

    loc2glob = np.zeros((n, m), np.int32)
    int_mask = np.zeros((n, m), np.float64)
    loc2shared = np.full((n, m), S, np.int32)
    j = np.arange(m)
    for d in range(n):
        k_s = s_lo[d] + j[:tail0][: 3 * n_s_loc] // 3
        loc2glob[d, :3 * n_s_loc] = 3 * s_lo[d] + j[:3 * n_s_loc]
        int_mask[d, :3 * n_s_loc] = (own_s[k_s] == d) & ~sh_s[k_s]
        slot = s_slot[k_s]
        sel = slot >= 0
        loc2shared[d, :3 * n_s_loc][sel] = (slot + j[:3 * n_s_loc] % 3)[sel]

        jr = j[3 * n_s_loc:tail0] - 3 * n_s_loc
        k_r = r_lo[d] + jr // 3
        loc2glob[d, 3 * n_s_loc:tail0] = off_r3_g + 3 * r_lo[d] + jr
        int_mask[d, 3 * n_s_loc:tail0] = (own_r[k_r] == d) & ~sh_r[k_r]
        slot = r_slot[k_r]
        sel = slot >= 0
        loc2shared[d, 3 * n_s_loc:tail0][sel] = (slot + jr % 3)[sel]

        loc2glob[d, tail0:] = off_tail_g + np.arange(tail_dim)
        # Separator tail (biases..intrinsics); point coords keep the
        # sentinel S (the one-hot maps them to zero rows -> excluded).
        loc2shared[d, tail0:tail0 + tail_dim_sep] = \
            3 * (n_sh_s + n_sh_r) + np.arange(tail_dim_sep)

    return KnotPartition(n=n, m=m, S=S, n_s_loc=n_s_loc, n_r_loc=n_r_loc,
                         s_lo=s_lo, r_lo=r_lo, loc2glob=loc2glob,
                         int_mask=int_mask, loc2shared=loc2shared,
                         shared2glob=shared2glob, layout_loc=layout_loc)


class SchurNE(NamedTuple):
    """Distributed normal equations: the local Hessians of this process's
    shards + the reduced separator block. The full D x D matrix never
    exists.

    Board points are a BORDERED third level (Csp/Cpp/g_P), not separator
    coords, so S stays independent of P."""

    H_loc: torch.Tensor   # (n_local, m, m) this process's shards
    g_loc: torch.Tensor   # (n_local, m)
    C: torch.Tensor       # (S, S) replicated: separator-separator sum
    g_S: torch.Tensor     # (S,)
    d_S: torch.Tensor     # (S,) separator diagonal sum (for equilibration)
    Csp: torch.Tensor | None = None   # (S, 3P) separator-point coupling sum
    Cpp: torch.Tensor | None = None   # (3P, 3P) raw point block (block-diag+prior)
    g_P: torch.Tensor | None = None   # (3P,)
    d_P: torch.Tensor | None = None   # (3P,)


def _touched(fams, d):
    """Shard d's (so3, r3) touched knot ranges over all three families."""
    (fam_obs, fam_acc, fam_gyr), p = fams
    tr_s, tr_r = [], []
    for fam, tk, vk, use_r3 in ((fam_obs, "obs_t", "obs_valid", True),
                                (fam_acc, "accel_t", "accel_valid", True),
                                (fam_gyr, "gyro_t", "gyro_valid", False)):
        ts = _touched_range(fam[tk][d], fam[vk][d], p.t0, p.dt_so3, p.n_so3, se.ORDER)
        if ts is not None:
            tr_s.append(ts)
        if use_r3:
            tr = _touched_range(fam[tk][d], fam[vk][d], p.t0, p.dt_r3, p.n_r3, se.ORDER)
            if tr is not None:
                tr_r.append(tr)

    def merge(rs):
        return (min(a for a, _ in rs), max(b for _, b in rs)) if rs else None

    return merge(tr_s), merge(tr_r)


def make_schur_solver_functions(p: se.SplineProblem, mesh: Mesh, axis: str = "data",
                                obs_chunk: int = 8192, imu_chunk: int = 2048):
    """(linearize_fn, cost_fn, solve_fn, layout, partition) for lm.lm_optimize.

    linearize returns ``(SchurNE, None, cost)`` for the pluggable
    lm.lm_optimize interface; ``solve_fn(NE, g, lam, free_mask)`` runs the
    distributed Schur elimination and returns a full (D,) tangent step (a
    vector of D floats is cheap to replicate; the D x D matrix is what must
    stay sharded). ``p`` holds the rows of this process's shards, as in
    ``sharded.make_sharded_fast_solver_functions_ex``.
    """
    n = mesh.n
    layout_g = se.build_layout(p)
    D = layout_g.tangent_dim
    dev = mesh.device

    ((fam_obs, k_obs), (fam_acc, k_acc), (fam_gyr, k_gyr)), obs_chunk, imu_chunk = \
        _shard_families(p, mesh, obs_chunk, imu_chunk)
    pl_o = _plan_family(fam_obs["obs_t"], p, obs_chunk, True, mesh)
    pl_a = _plan_family(fam_acc["accel_t"], p, imu_chunk, True, mesh)
    pl_g = _plan_family(fam_gyr["gyro_t"], p, imu_chunk, False, mesh)
    fams = (fam_obs, fam_acc, fam_gyr)
    touched = [_touched((fams, p), j) for j in range(len(mesh.local))]
    touched = [t for got in gather_objects(touched, mesh) for t in got]

    part = partition_knots(p, n, (pl_o, pl_a, pl_g, touched))

    dummy = np.zeros((1,), np.int64)
    plans = (se.ChunkPlan(k_obs, obs_chunk, pl_o[0], pl_o[1], dummy, dummy),
             se.ChunkPlan(k_acc, imu_chunk, pl_a[0], pl_a[1], dummy, dummy),
             se.ChunkPlan(k_gyr, imu_chunk, pl_g[0], 0, dummy, dummy))
    lin_local = se.make_fast_linearizer(p, part.layout_loc, plans, include_prior=False)

    loc = list(mesh.local)
    data = [(_local_arrays(fams, j, dev),
             dict(obs_s=pl_o[2][d], obs_r=pl_o[3][d], acc_s=pl_a[2][d], acc_r=pl_a[3][d],
                  gyr_s=pl_g[2][d], s_org=int(part.s_lo[d]), r_org=int(part.r_lo[d])))
            for j, d in enumerate(loc)]
    S, m = part.S, part.m
    dtype = p.obs_uv.dtype
    l2g = torch.as_tensor(part.loc2glob[loc], dtype=torch.int64, device=dev)  # (n_loc, m)
    imask = torch.as_tensor(part.int_mask[loc], dtype=dtype, device=dev)
    # (n_loc, m, S) one-hot of each local coordinate's separator slot
    # (interior and point coordinates carry the sentinel S: zero rows).
    E = F.one_hot(torch.as_tensor(part.loc2shared[loc], dtype=torch.int64, device=dev),
                  S + 1)[..., :S].to(dtype)
    sh2g = torch.as_tensor(part.shared2glob, dtype=torch.int64, device=dev)

    has_points = p.n_points > 0
    has_prior = has_points and p.pt_prior_sqrt_info is not None
    P3 = 3 * p.n_points
    pts0 = part.m - P3  # points are the LAST tail coords of layout_loc
    pts_glob = torch.as_tensor(layout_g.offsets["points"] + np.arange(P3), device=dev) \
        if has_points else None

    def linearize_fn(params):
        outs = [lin_local(params, arrs, bases) for arrs, bases in data]
        H_loc, g_loc = torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
        c = _sum_shards(o[2] for o in outs)
        Et = E.transpose(1, 2)
        diag = torch.diagonal(H_loc, dim1=1, dim2=2)
        red = [torch.sum(Et @ H_loc @ E, dim=0), torch.sum(Et @ g_loc[..., None], dim=0)[:, 0],
               torch.sum(Et @ diag[..., None], dim=0)[:, 0], c]
        if has_points:
            red += [torch.sum(Et @ H_loc[:, :, pts0:], dim=0),
                    torch.sum(H_loc[:, pts0:, pts0:], dim=0), torch.sum(g_loc[:, pts0:], dim=0),
                    torch.sum(diag[:, pts0:], dim=0)]
        for t in red:
            all_reduce(t, mesh)
        C, g_S, d_S, c = red[:4]
        Csp = Cpp = g_P = d_P = None
        if has_points:
            Csp, Cpp, g_P, d_P = red[4:]
        if has_prior:
            # Prior added ONCE, after the reduction, to the point system.
            Wq = p.pt_prior_sqrt_info
            rq = torch.einsum("pij,pj->pi", Wq, params["points"] - p.pt_prior_mean)
            Hq = torch.einsum("pki,pkj->pij", Wq, Wq)  # (P, 3, 3)
            gq = torch.einsum("pij,pi->pj", Wq, rq)
            ii = 3 * torch.arange(p.n_points, device=dev)[:, None] + torch.arange(3, device=dev)
            Cpp = Cpp.index_put((ii[:, :, None], ii[:, None, :]), Hq, accumulate=True)
            g_P = g_P.index_put((ii,), gq, accumulate=True)
            d_P = d_P.index_put((ii,), torch.diagonal(Hq, dim1=1, dim2=2), accumulate=True)
            c = c + 0.5 * torch.sum(rq * rq)
        return SchurNE(H_loc, g_loc, C, g_S, d_S, Csp, Cpp, g_P, d_P), None, c

    def solve_fn(NE, _unused_g, lam, free_mask):
        H_loc, g_loc, C, g_S, d_S = NE.H_loc, NE.g_loc, NE.C, NE.g_S, NE.d_S
        fm = free_mask.to(H_loc.dtype)
        fm_loc = fm[l2g]
        fm_S = fm[sh2g]

        # Jacobi equilibration with globally consistent diagonals (shared
        # coords use the reduced diagonal so both sides scale identically).
        d_loc = torch.diagonal(H_loc, dim1=1, dim2=2)
        d_full = torch.where(imask > 0, d_loc, (E @ d_S[:, None])[..., 0])
        s_loc = torch.rsqrt(torch.clamp(d_full, min=1e-12))
        s_S = torch.rsqrt(torch.clamp(d_S, min=1e-12))

        a = imask * fm_loc * s_loc          # active interior scaling
        ind = imask * fm_loc                # 0/1 active-interior indicator
        A = H_loc * a[:, :, None] * a[:, None, :] + torch.diag_embed(1.0 - ind + lam * ind)
        b_S = fm_S * s_S
        B = (a[:, :, None] * H_loc) @ (E * b_S)   # (n_loc, m, S)
        eye_S = torch.eye(S, dtype=C.dtype, device=dev)
        C_s = C * b_S[:, None] * b_S[None, :] + eye_S * (1.0 - fm_S + lam * fm_S)
        g_i = a * g_loc
        g_Ss = b_S * g_S

        L, info = torch.linalg.cholesky_ex(A)  # batched over the local shards

        if has_points:
            fm_P = fm[pts_glob]
            s_P = torch.rsqrt(torch.clamp(NE.d_P, min=1e-12))
            b_P = fm_P * s_P
            Bp = (a[:, :, None] * H_loc[:, :, pts0:]) * b_P   # (n_loc, m, 3P)
            F0 = (b_S[:, None] * NE.Csp) * b_P[None, :]       # (S, 3P)
            Cp_s = NE.Cpp * b_P[:, None] * b_P[None, :] + torch.diag(1.0 - fm_P + lam * fm_P)
            g_Ps = b_P * NE.g_P
            RHS = torch.cat([B, Bp, g_i[..., None]], dim=2)
            AinvR = torch.cholesky_solve(RHS, L)
            corr = all_reduce(torch.sum(RHS.transpose(1, 2) @ AinvR, dim=0), mesh)
            S_red = C_s - corr[:S, :S]
            Fr = F0 - corr[:S, S:S + P3]
            Gr = Cp_s - corr[S:S + P3, S:S + P3]
            rs = g_Ss - corr[:S, -1]
            rp = g_Ps - corr[S:S + P3, -1]
            Ls, info_s = torch.linalg.cholesky_ex(S_red)
            X = torch.cholesky_solve(Fr, Ls)  # (S, 3P)
            y = torch.cholesky_solve(rs[:, None], Ls)[:, 0]
            Gp = Gr - Fr.T @ X
            Lp, info_p = torch.linalg.cholesky_ex(Gp)
            x_P = torch.cholesky_solve((Fr.T @ y - rp)[:, None], Lp)[:, 0]
            x_S = -(y + X @ x_P)
            x_i = (-AinvR[..., -1] - (AinvR[..., :S] @ x_S[:, None])[..., 0]
                   - (AinvR[..., S:S + P3] @ x_P[:, None])[..., 0])
            ok_S = (info_s == 0) & (info_p == 0)
        else:
            AinvB = torch.cholesky_solve(B, L)
            Ainvg = torch.cholesky_solve(g_i[..., None], L)[..., 0]
            S_red = C_s - all_reduce(torch.sum(B.transpose(1, 2) @ AinvB, dim=0), mesh)
            rhs = g_Ss - all_reduce(torch.sum((B.transpose(1, 2) @ Ainvg[..., None])[..., 0],
                                              dim=0), mesh)
            Ls, info_s = torch.linalg.cholesky_ex(S_red)
            x_S = torch.cholesky_solve(-rhs[:, None], Ls)[:, 0]
            x_i = -Ainvg - (AinvB @ x_S[:, None])[..., 0]
            ok_S = info_s == 0

        # A failed local factorization poisons its shard's part of the
        # step, and so the reduced step on every process.
        x_i = torch.where((info == 0)[:, None], x_i, torch.full_like(x_i, float("nan")))
        delta = torch.zeros((D,), dtype=H_loc.dtype, device=dev)
        delta.index_add_(0, l2g.reshape(-1), (a * x_i).reshape(-1))
        all_reduce(delta, mesh)
        delta = delta.index_add(0, sh2g, b_S * x_S)
        if has_points:
            delta = delta.index_add(0, pts_glob, b_P * x_P)
        # Replication canary: x_S is solved from reduced quantities and
        # must be identical on every process; a diverged replica turns
        # the step into NaN so the LM loop rejects it.
        mean_xS = all_reduce(x_S.clone(), mesh) / world_size(mesh)
        canary = all_reduce(torch.max(torch.abs(x_S - mean_xS)).reshape(1), mesh, op="max")[0]
        scale = 1.0 + torch.max(torch.abs(delta))
        good = ok_S & (canary < 1e-3 * scale)
        return torch.where(good, delta, torch.full_like(delta, float("nan")))

    def cost_fn(params):
        c = all_reduce(_sum_shards(_cost_of(params, p, arrs) for arrs, _ in data), mesh)
        if has_prior:
            rq = torch.einsum("pij,pj->pi", p.pt_prior_sqrt_info,
                              params["points"] - p.pt_prior_mean)
            c = c + 0.5 * torch.sum(rq * rq)
        return c

    return linearize_fn, cost_fn, solve_fn, layout_g, part


def optimize_schur(p: se.SplineProblem, params0: dict, mesh: Mesh,
                   flags: frozenset = se.DEFAULT_FLAGS, max_iters: int = 50,
                   config: lm.LMConfig | None = None, obs_chunk: int = 8192,
                   imu_chunk: int = 2048, axis: str = "data") -> lm.LMResult:
    """LM with the knot-sharded Schur linear solver (drop-in for
    sharded.optimize_sharded at larger D)."""
    lin, cost, solve, layout, _ = make_schur_solver_functions(
        p, mesh, axis=axis, obs_chunk=obs_chunk, imu_chunk=imu_chunk)
    ref = next(iter(params0.values()))
    mask = layout.free_mask(fixed=se.flags_to_fixed(flags), dtype=ref.dtype, device=ref.device)
    cfg = config or lm.LMConfig(max_iters=max_iters, ftol=1e-4)
    return lm.lm_optimize(lin, cost, layout.retract, params0, mask, cfg,
                          solve_fn=lambda NE, g, lam: solve(NE, g, lam, mask),
                          mask_fn=lambda NE, g, _m: (NE, g))
