"""Multi-sequence batched continuous-time calibration (BASELINE configs[4]).

Port of ``core/batch_estimator.py`` of the JAX package. N recordings are
solved together:

* ``mode="independent"`` — N sequences, N separate solutions: every
  per-sequence measurement array is padded to common shapes and stacked on
  a leading sequence axis; one linearization covers all N (the fast
  linearizer with ``n_seq=N``: residuals and Jacobians through one
  ``torch.func.vmap`` over the sequences, one kernel launch per family for
  all N*K chunks), and the LM loop runs per lane
  (``lm.lm_optimize_lanes``, the JAX package's ``vmap(lm_optimize)``), so
  each sequence keeps its own damping, iterations and status. Numerically
  equivalent to N single-sequence solves (tested).

* ``mode="joint"`` — one rig recorded N times. Per-sequence trajectories,
  biases, gravity (and by default the clock offset) stay per-sequence; the
  rig parameters in ``shared`` (T_imu_cam, rolling-shutter line delay, IMU
  intrinsics) are constrained equal across sequences. The normal equations
  then have arrowhead structure, block-diagonal per-sequence systems
  bordered by the small shared block, and the solve is a batched-Cholesky
  Schur elimination onto the shared block:

      S  = sum_i (C_i - B_i^T A_i^{-1} B_i)          (S x S, tiny)
      ds = S^{-1} (sum_i B_i^T A_i^{-1} gx_i - gs)
      dx_i = -A_i^{-1} (gx_i + B_i ds)               (batched)

Constraints: sequences must share the camera model and intrinsics, the
rolling-shutter mode and the trajectory knot spacings dt_so3/dt_r3 (use a
common SEW choice, e.g. the minimum over sequences). Per-sequence time
origins, SEW weights, bias-knot spacing and valid-time bounds go through
the linearizer's ``bases`` (``spline_estimator.PROBLEM_OVERRIDE_KEYS``).
Board-point (POINTS) blocks are not supported in batch mode.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.func import vmap

from openimucameracalibrator_torch.core import spline_estimator as se
from openimucameracalibrator_torch.solver import lm, robust

# Rig parameters shared across sequences in joint mode. gravity and
# time_offset stay per-sequence by default (each recording has its own
# world frame; clock alignment can drift between recordings): pass a
# custom ``shared`` tuple to optimize_batch to change that.
DEFAULT_SHARED = ("q_i_c", "t_i_c", "line_delay", "accl_intr", "gyro_intr")


class SequenceBatch(NamedTuple):
    """N padded sequences stacked for one batched solver."""

    p_ref: se.SplineProblem  # common statics, knot counts = per-seq maxima
    plans: tuple  # common ChunkPlan triple (widths = per-seq maxima)
    arrs: dict  # stacked chunked measurement tensors, leading axis N
    bases: dict  # shared per-chunk knot bases (host) + per-seq scalar overrides (N,)
    pad_masks: np.ndarray  # (N, D) 1.0 on real tangent coords, 0.0 on padding
    knot_counts: tuple  # [(n_so3_i, n_r3_i, n_bias_i)] for unpadding
    n_seq: int


def _common_statics(problems: Sequence[se.SplineProblem]) -> None:
    p0 = problems[0]
    for k, p in enumerate(problems[1:], 1):
        for f in ("model_name", "rolling_shutter", "dt_so3", "dt_r3"):
            if getattr(p, f) != getattr(p0, f):
                raise ValueError(
                    f"sequence {k} differs from sequence 0 in {f!r} "
                    f"({getattr(p, f)} vs {getattr(p0, f)}); batched "
                    "sequences must share the camera model and knot "
                    "spacings (pick one SEW dt, e.g. the minimum)")
        if not np.array_equal(p.cam_params.cpu().numpy(), p0.cam_params.cpu().numpy()):
            raise ValueError(f"sequence {k} has different camera intrinsics")
        if p.n_points > 0 or p0.n_points > 0:
            raise ValueError("POINTS blocks are not supported in batch mode")


def _pad_axis0(x: torch.Tensor, n: int, value=0) -> torch.Tensor:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    fill = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill])


def _unify(plans, n_knots_s, n_knots_r):
    """ONE chunk-base schedule covering every sequence.

    Sequences share the camera fps, IMU rate and knot spacings, so chunk k
    of every sequence spans (nearly) the same window of knot indices; a
    common base = elementwise min with the window widened to the common
    coverage keeps the chunk geometry host-known and shared, which is what
    lets one kernel launch take the chunks of all sequences.
    """
    k = max(pl.n_chunks for pl in plans)

    def merged(bases_list, widths, n_knots):
        lo = np.full(k, np.iinfo(np.int32).max, np.int64)
        hi = np.zeros(k, np.int64)
        for pl_base, w in zip(bases_list, widths):
            b = np.asarray(pl_base)
            lo[:len(b)] = np.minimum(lo[:len(b)], b)
            hi[:len(b)] = np.maximum(hi[:len(b)], b + w)
        lo[lo == np.iinfo(np.int32).max] = 0
        w_common = min(int(np.max(hi - lo)) if k else 1, n_knots)
        base = np.clip(lo, 0, max(n_knots - w_common, 0))
        return base.astype(np.int64), w_common

    s_base, w_s = merged([pl.s_base for pl in plans], [pl.w_s for pl in plans], n_knots_s)
    r_base, w_r = merged([pl.r_base for pl in plans], [max(pl.w_r, 1) for pl in plans],
                         n_knots_r)
    if all(pl.w_r == 0 for pl in plans):
        w_r = 0
    common = se.ChunkPlan(n_chunks=k, chunk=plans[0].chunk, w_s=w_s, w_r=w_r,
                          s_base=s_base, r_base=r_base)
    return common, s_base, r_base


def build_sequence_batch(problems: Sequence[se.SplineProblem], obs_chunk: int = 2048,
                         imu_chunk: int = 256) -> SequenceBatch:
    """Pad + stack N problems (on one device) into one batch."""
    _common_statics(problems)
    p0 = problems[0]
    n_so3 = max(p.n_so3 for p in problems)
    n_r3 = max(p.n_r3 for p in problems)
    n_bias = max(p.n_bias for p in problems)
    p_ref = p0._replace(n_so3=n_so3, n_r3=n_r3, n_bias=n_bias, t0=0.0)

    per = [se.plan_fast_assembly(p, obs_chunk, imu_chunk) for p in problems]
    plan_lists = list(zip(*[pl for pl, _ in per]))  # (obs, acc, gyr) lists
    obs_plan, obs_s, obs_r = _unify(plan_lists[0], n_so3, n_r3)
    acc_plan, acc_s, acc_r = _unify(plan_lists[1], n_so3, n_r3)
    gyr_plan, gyr_s, _ = _unify(plan_lists[2], n_so3, n_r3)

    # Stack chunked arrays, padding the chunk axis to the common count.
    k_of = {"obs": obs_plan.n_chunks, "acc": acc_plan.n_chunks, "gyr": gyr_plan.n_chunks}
    arrs = {}
    for key in per[0][1]:
        fam = "acc" if key.startswith("accel") else "gyr" if key.startswith("gyro") else "obs"
        val = False if key.endswith("valid") else 0
        arrs[key] = torch.stack([_pad_axis0(a[key], k_of[fam], val) for _, a in per])

    dtype, dev = p0.obs_uv.dtype, p0.obs_uv.device

    def T(vals):
        return torch.tensor(vals, dtype=dtype, device=dev)

    # Chunk bases are host arrays shared by all sequences (see _unify); the
    # per-sequence scalars are (N,) tensors.
    bases = dict(
        obs_s=obs_s, obs_r=obs_r, acc_s=acc_s, acc_r=acc_r, gyr_s=gyr_s,
        t0=T([p.t0 for p in problems]),
        w_accel=T([p.w_accel for p in problems]),
        w_gyro=T([p.w_gyro for p in problems]),
        dt_bias=T([p.dt_bias for p in problems]),
        # Each sequence's REAL valid-time bound: knot arrays are padded to
        # the batch maximum, so the padded range must not admit
        # measurements past the sequence's own spline support.
        t_hi=T([min(p.t0 + min((p.n_so3 - se.ORDER + 1) * p.dt_so3,
                               (p.n_r3 - se.ORDER + 1) * p.dt_r3),
                     np.inf if p.t_hi is None else p.t_hi)
                for p in problems]))

    layout = se.build_layout(p_ref)
    pad_masks = np.ones((len(problems), layout.tangent_dim))
    for i, p in enumerate(problems):
        partial = {}
        for name, n_real, n_pad in (("q_so3", p.n_so3, n_so3), ("t_r3", p.n_r3, n_r3),
                                    ("bias_a", p.n_bias, n_bias), ("bias_g", p.n_bias, n_bias)):
            m = np.ones((n_pad, 3))
            m[n_real:] = 0.0
            partial[name] = m
        pad_masks[i] = layout.free_mask(partial_masks=partial).numpy()

    return SequenceBatch(p_ref=p_ref, plans=(obs_plan, acc_plan, gyr_plan), arrs=arrs,
                         bases=bases, pad_masks=pad_masks,
                         knot_counts=tuple((p.n_so3, p.n_r3, p.n_bias) for p in problems),
                         n_seq=len(problems))


def make_batch_cost(p_ref: se.SplineProblem):
    """cost(params, arrs, bases) from the stacked chunked arrays (one
    sequence's slice: arrs leaves (K, C, ...), the overrides scalars)."""

    def cost(params, arrs, bases):
        pov = {k: bases[k] for k in se.PROBLEM_OVERRIDE_KEYS if k in bases}
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in arrs.items()}
        pc = p_ref._replace(**flat, **pov)
        ra, _, _ = se._accel_eval(params, pc, with_jac=False)
        rg, _, _ = se._gyro_eval(params, pc, with_jac=False)
        rp, _, _ = se._reproj_eval(params, pc, with_jac=False)
        c = 0.5 * torch.sum(ra * ra) + 0.5 * torch.sum(rg * rg)
        return c + robust.huber_cost(rp.reshape(-1), se.HUBER_PX, group_size=2)

    return cost


def stack_params(batch: SequenceBatch, params_list: Sequence[dict]) -> dict:
    """Pad per-sequence init params to the batch shapes and stack (N, ...).

    Padded SO(3) knots are identity quaternions (valid manifold points);
    padded Euclidean knots are zero. Both are frozen by ``pad_masks`` and
    touched by no measurement.
    """
    p_ref = batch.p_ref
    out = {}
    for k in params_list[0]:
        rows = {"q_so3": p_ref.n_so3, "t_r3": p_ref.n_r3,
                "bias_a": p_ref.n_bias, "bias_g": p_ref.n_bias}.get(k)
        vals = []
        for prm in params_list:
            v = prm[k]
            if rows is not None and v.shape[0] < rows:
                pad = torch.zeros((rows - v.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype,
                                  device=v.device)
                if k == "q_so3":
                    pad[:, 0] = 1.0
                v = torch.cat([v, pad])
            vals.append(v)
        out[k] = torch.stack(vals)
    return out


def unstack_params(batch: SequenceBatch, params_b: dict) -> list:
    """Per-sequence param dicts, trimmed back to each sequence's knot counts."""
    out = []
    for i, (n_so3, n_r3, n_bias) in enumerate(batch.knot_counts):
        rows = {"q_so3": n_so3, "t_r3": n_r3, "bias_a": n_bias, "bias_g": n_bias}
        out.append({k: (v[i][:rows[k]] if k in rows else v[i]) for k, v in params_b.items()})
    return out


def _batch_masks(batch: SequenceBatch, layout, flags: frozenset) -> torch.Tensor:
    flags_mask = layout.free_mask(fixed=se.flags_to_fixed(flags)).numpy()
    ref = batch.p_ref.obs_uv
    return torch.as_tensor(batch.pad_masks * flags_mask[None, :], dtype=ref.dtype,
                           device=ref.device)


def make_arrowhead_solver(layout, shared: Sequence[str]):
    """Damped solve for the joint system.

    ``solve_fn(H_b (N,D,D), g_b (N,D), lam) -> delta (N, D)`` with the
    shared components of delta equal across sequences. Jacobi-equilibrated
    like lm._solve_damped: per-sequence coords scale by their own diagonal,
    shared coords by the cross-sequence summed diagonal, then +lam*I
    Marquardt damping in the scaled space. The N per-sequence blocks are
    factored by one batched Cholesky; a failed factorization gives a NaN
    step, which the LM loop rejects.
    """
    shared_np = np.concatenate([np.arange(layout.slice_of(n).start, layout.slice_of(n).stop)
                                for n in shared])
    seq_np = np.setdiff1d(np.arange(layout.tangent_dim), shared_np)

    def solve(H_b, g_b, lam):
        dev = H_b.device
        shared_idx = torch.as_tensor(shared_np, device=dev)
        seq_j = torch.as_tensor(seq_np, device=dev)
        A = H_b[:, seq_j[:, None], seq_j[None, :]]  # (N, Dx, Dx)
        B = H_b[:, seq_j[:, None], shared_idx[None, :]]  # (N, Dx, S)
        C = torch.sum(H_b[:, shared_idx[:, None], shared_idx[None, :]], dim=0)
        gx = g_b[:, seq_j]
        gs = torch.sum(g_b[:, shared_idx], dim=0)

        sx = torch.rsqrt(torch.clamp(torch.diagonal(A, dim1=1, dim2=2), min=1e-12))  # (N, Dx)
        ss = torch.rsqrt(torch.clamp(torch.diagonal(C), min=1e-12))  # (S,)
        eye_x = torch.eye(A.shape[1], dtype=A.dtype, device=dev)
        As = A * sx[:, :, None] * sx[:, None, :] + lam * eye_x
        Bs = B * sx[:, :, None] * ss[None, None, :]
        Cs = C * ss[:, None] * ss[None, :] + lam * torch.eye(C.shape[0], dtype=C.dtype,
                                                             device=dev)
        gxs = gx * sx
        gss = gs * ss

        L, info = torch.linalg.cholesky_ex(As)
        AiB = torch.cholesky_solve(Bs, L)  # (N, Dx, S)
        Aig = torch.cholesky_solve(gxs[:, :, None], L)[:, :, 0]  # (N, Dx)
        S_mat = Cs - torch.einsum("nxs,nxt->st", Bs, AiB)
        rhs = torch.einsum("nxs,nx->s", Bs, Aig) - gss
        ds, info_s = torch.linalg.solve_ex(S_mat, rhs)
        dx = -(Aig + torch.einsum("nxs,s->nx", AiB, ds))
        delta = torch.zeros_like(g_b)
        delta[:, seq_j] = dx * sx
        delta[:, shared_idx] = (ds * ss)[None, :]
        ok = torch.all(info == 0) & (info_s == 0)
        return torch.where(ok, delta, torch.full_like(delta, float("nan")))

    return solve


class BatchResult(NamedTuple):
    """Per-sequence solutions + solver diagnostics.

    ``params`` — list of per-sequence parameter dicts (original knot
    counts). In joint mode the ``shared`` blocks are identical across
    sequences. Diagnostics are per-sequence (N,) tensors in independent
    mode and one joint solve's scalars in joint mode.
    """

    params: list
    cost: torch.Tensor
    iterations: torch.Tensor | int
    converged: torch.Tensor | bool
    status: torch.Tensor | int
    seconds: float = 0.0
    linearizations: int = 0


def make_batch_linearizer(batch: SequenceBatch, layout, sequential: bool = False,
                          gram_dtype=None):
    """``lin(params_b) -> (H (N,D,D), g (N,D), cost (N,))`` of the whole
    batch: the fast linearizer over N stacked problems, one kernel launch
    per family for all sequences (``sequential``: one per chunk)."""
    lin = se.make_fast_linearizer(batch.p_ref, layout, batch.plans, include_prior=False,
                                  sequential=sequential, gram_dtype=gram_dtype,
                                  n_seq=batch.n_seq)
    return lambda params_b: lin(params_b, batch.arrs, batch.bases)


def optimize_batch(problems: Sequence[se.SplineProblem], params0_list: Sequence[dict],
                   flags: frozenset = se.DEFAULT_FLAGS, config: lm.LMConfig | None = None,
                   mode: str = "independent", shared: Sequence[str] = DEFAULT_SHARED,
                   obs_chunk: int = 2048, imu_chunk: int = 256) -> BatchResult:
    """Calibrate N sequences in one batched solve (see module doc); the
    problems and parameters live on one device (their own).

    Reference analog: none. The reference runs its per-dataset pipeline
    once per recording with no way to share rig parameters across
    recordings.
    """
    if mode not in ("independent", "joint"):
        raise ValueError(f"unknown mode {mode!r}")
    batch = build_sequence_batch(problems, obs_chunk, imu_chunk)
    layout = se.build_layout(batch.p_ref)
    lin = make_batch_linearizer(batch, layout)
    cost = make_batch_cost(batch.p_ref)
    params_b = stack_params(batch, params0_list)
    masks = _batch_masks(batch, layout, flags)
    cfg = config or lm.LMConfig(max_iters=50, ftol=1e-4)
    scal_b = {k: batch.bases[k] for k in se.PROBLEM_OVERRIDE_KEYS}
    retract_b = vmap(layout.retract)

    def cost_b(prm_b):
        return vmap(cost)(prm_b, batch.arrs, scal_b)

    if mode == "independent":
        res = lm.lm_optimize_lanes(lin, cost_b, retract_b, params_b, masks, cfg)
        return BatchResult(params=unstack_params(batch, res.params), cost=res.cost,
                           iterations=res.iterations, converged=res.converged,
                           status=res.status, seconds=res.seconds,
                           linearizations=res.linearizations)

    # --- joint mode: one scalar LM over the arrowhead system ---
    for name in shared:
        if name not in layout.by_name:
            raise ValueError(f"unknown shared block {name!r}")
    solve_fn = make_arrowhead_solver(layout, shared)

    def linearize_joint(prm_b):
        H_b, g_b, costs = lin(prm_b)
        return H_b, g_b, torch.sum(costs)

    def mask_joint(H_b, g_b, mask_b):
        m = mask_b.to(g_b.dtype)
        eye = torch.eye(m.shape[1], dtype=m.dtype, device=m.device)
        return H_b * m[:, :, None] * m[:, None, :] + eye * (1.0 - m)[:, None, :], g_b * m

    res = lm.lm_optimize(linearize_joint, lambda prm_b: torch.sum(cost_b(prm_b)), retract_b,
                         params_b, masks, cfg, solve_fn=solve_fn, mask_fn=mask_joint)
    return BatchResult(params=unstack_params(batch, res.params), cost=res.cost,
                       iterations=res.iterations, converged=res.converged, status=res.status,
                       seconds=res.seconds, linearizations=res.linearizations)
