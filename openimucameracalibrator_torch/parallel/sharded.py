"""Data-parallel sharded solver: measurement shards, summed normal equations.

Port of ``parallel/sharded.py`` of the JAX package, on ``torch.distributed``:

* the ``data`` axis: accelerometer, gyro and reprojection measurements are
  split into contiguous time shards; spline knots and calibration
  parameters are replicated (a few thousand floats);
* each shard assembles the dense normal-equation contribution of its
  measurements with the fast chunk linearizer of the single-device path
  (``core/spline_estimator.py``; the fused Gram kernel on the card), then
  (H, g, cost) are summed over the shards: in one process over the shards
  it holds, then across processes with ``all_reduce`` (the JAX package's
  ``psum``);
* the damped solve and the retraction run replicated on every process.

A :class:`Mesh` serves both layouts with the same code: ``n`` shards in one
process on one device (:func:`make_mesh`), or one shard per process over a
``torch.distributed`` group (``parallel/multihost.global_mesh``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from openimucameracalibrator_torch.core import spline_estimator as se
from openimucameracalibrator_torch.solver import lm, robust
from openimucameracalibrator_torch.utils import precision

# SplineProblem fields sharded along their leading (measurement) axis.
# obs_pt_id / obs_sqrt_info join when the POINTS block is active.
_SHARDED_FIELDS = ("accel_t", "accel_meas", "accel_valid",
                   "gyro_t", "gyro_meas", "gyro_valid",
                   "obs_t", "obs_row", "obs_uv", "obs_pt", "obs_valid",
                   "obs_pt_id", "obs_sqrt_info")
_REPLICATED_ARRAY_FIELDS = ("cam_params", "pt_prior_mean", "pt_prior_sqrt_info")


class Mesh(NamedTuple):
    """``n`` shards along ``axis``; this process runs the shards ``local``
    on ``device``. ``group`` is the ``torch.distributed`` group the shards'
    sums are reduced over, None when one process holds every shard."""

    n: int
    local: tuple
    device: torch.device
    group: object = None
    axis: str = "data"


def make_mesh(n_devices: int | None = None, axis: str = "data", device=None) -> Mesh:
    """``n_devices`` shards (default 1) in this process on ``device``
    (default ``"cuda"``; raises without one unless ``"cpu"`` is asked for)."""
    n = n_devices or 1
    return Mesh(n=n, local=tuple(range(n)), device=_indexed(precision.resolve_device(device)),
                axis=axis)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:{current}``, so that it compares equal to the
    device of the tensors made on it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place across the mesh's processes (no-op without a
    group). Gloo on CUDA tensors is staged through the host explicitly."""
    if mesh.group is None:
        return t
    import torch.distributed as dist

    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if t.is_cuda and dist.get_backend(mesh.group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=rop, group=mesh.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=rop, group=mesh.group)
    return t


def world_size(mesh: Mesh) -> int:
    """Processes the mesh spans (1 without a group)."""
    if mesh.group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(mesh.group)


def gather_objects(obj, mesh: Mesh) -> list:
    """Every process's ``obj``, in rank order ([obj] without a group)."""
    if mesh.group is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _sharded_fields(p: se.SplineProblem):
    return tuple(f for f in _SHARDED_FIELDS if getattr(p, f) is not None)


def _replicated_fields(p: se.SplineProblem):
    return tuple(f for f in _REPLICATED_ARRAY_FIELDS if getattr(p, f) is not None)


def _add_prior_outside(linearize_fn, cost_fn, p: se.SplineProblem, layout):
    """Wrap sharded ``(params, data)`` (linearize, cost) to add the
    board-point prior ONCE, after the reduction over shards (inside each
    shard it would be multiplied by the shard count)."""
    if p.n_points == 0 or p.pt_prior_sqrt_info is None:
        return linearize_fn, cost_fn

    def lin(params, data):
        H, g, c = linearize_fn(params, data)
        rq, Wq, iq = se._point_prior_eval(params, p, layout)
        H, g = se._scatter(H, g, rq, Wq, iq)
        return H, g, c + 0.5 * torch.sum(rq * rq)

    def cost(params, data):
        c = cost_fn(params, data)
        rq, _, _ = se._point_prior_eval(params, p, layout)
        return c + 0.5 * torch.sum(rq * rq)

    return lin, cost


def _bind(lin2, cost2, data):
    """Close (params, data) functions over the shard data."""
    return (lambda params: lin2(params, data)), (lambda params: cost2(params, data))


def _pad_to_multiple(x: torch.Tensor, n: int, pad_value=0):
    m = x.shape[0]
    target = ((m + n - 1) // n) * n
    if target == m:
        return x
    fill = torch.full((target - m,) + tuple(x.shape[1:]), pad_value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill])


def pad_problem(p: se.SplineProblem, n_shards: int) -> se.SplineProblem:
    """Pad each measurement batch to a multiple of the shard count; padding
    entries carry valid=False so they contribute exactly zero."""
    upd: Dict = {}
    for f in _sharded_fields(p):
        pad_value = False if f.endswith("_valid") else 0
        upd[f] = _pad_to_multiple(getattr(p, f), n_shards, pad_value)
    return p._replace(**upd)


def split_problem(p: se.SplineProblem):
    """(sharded array dict, replicated array dict, static-field dict)."""
    shf, ref = _sharded_fields(p), _replicated_fields(p)
    sharded = {f: getattr(p, f) for f in shf}
    repl = {f: getattr(p, f) for f in ref}
    static = {f: getattr(p, f) for f in p._fields if f not in shf and f not in ref}
    return sharded, repl, static


def _pad_family(arrs: Dict, times_key: str, valid_key: str, n: int, chunk: int):
    """numpy: shard a measurement family into n contiguous EQUAL row
    ranges of ceil(m/n), pad each shard to k*chunk, and reshape to
    (n, k, chunk, ...). Pad times repeat the shard's last sample (keeps
    the padded chunk's knot window local); pad entries carry valid=False.

    The per-shard split keeps every shard's rows its own contiguous slice:
    padding the flat array at the end and reshaping would pack all real
    rows into the first ceil(m/chunk) shards whenever the per-shard row
    count is below ``chunk``."""
    t = np.asarray(arrs[times_key])
    m = t.shape[0]
    m_loc = -(-m // n) if m else 1
    k = max(1, -(-m_loc // chunk))
    cap = k * chunk
    out = {}
    for name, x in arrs.items():
        x = np.asarray(x)
        shards = []
        for d in range(n):
            seg = x[d * m_loc:min((d + 1) * m_loc, m)]
            pad = cap - seg.shape[0]
            if name == times_key:
                fill = (seg[-1] if seg.shape[0] else (x[-1] if m else 0.0))
                pad_arr = np.full((pad,), fill, x.dtype)
            elif name == valid_key:
                pad_arr = np.zeros((pad,), bool)
            else:
                pad_arr = np.zeros((pad,) + x.shape[1:], x.dtype)
            shards.append(np.concatenate([seg, pad_arr]))
        out[name] = np.stack(shards).reshape((n, k, chunk) + x.shape[1:])
    return out, k


def _effective_chunk(total_rows: int, n: int, chunk: int, quantum: int = 256) -> int:
    """Cap a chunk size at the (quantum-rounded) per-shard size: with few
    rows per shard a full-size chunk is pure padding compute (every chunk
    processes ``chunk`` rows regardless of validity)."""
    m_loc = max(1, -(-total_rows // n))
    return max(quantum, min(chunk, -(-m_loc // quantum) * quantum))


def _plan_family(times_3d: np.ndarray, p: se.SplineProblem, chunk: int, use_r3: bool,
                 mesh: Mesh | None = None):
    """Per-shard chunk plans with a SHARED window size (max over shards), so
    that every shard runs the same linearizer. Shrinking a base to fit the
    larger window never loses coverage (base only moves down while the
    window grows). ``times_3d`` holds this process's shards; with a process
    group the plans of every process are gathered first, so the result
    covers all ``mesh.n`` shards in rank order."""
    plans = [se._plan_chunks(times_3d[d].reshape(-1), p, chunk, use_r3)
             for d in range(times_3d.shape[0])]
    if mesh is not None:
        plans = [pl for got in gather_objects(plans, mesh) for pl in got]
    w_s = max(pl.w_s for pl in plans)
    w_r = max(pl.w_r for pl in plans)
    s_base = np.stack([np.clip(np.asarray(pl.s_base), 0, p.n_so3 - w_s) for pl in plans])
    r_base = np.stack([np.clip(np.asarray(pl.r_base), 0, max(p.n_r3 - max(w_r, 1), 0))
                       for pl in plans])
    return w_s, w_r, s_base.astype(np.int32), r_base.astype(np.int32)


def _numpy_fields(p: se.SplineProblem, keys) -> dict:
    return {k: getattr(p, k).cpu().numpy() for k in keys}


def _shard_families(p: se.SplineProblem, mesh: Mesh, obs_chunk: int, imu_chunk: int):
    """This process's measurement rows split into its local shards:
    ({family: (n_local, k, chunk, ...) numpy arrays}, obs_chunk, imu_chunk)."""
    _check_device(p, mesh)
    n_loc = len(mesh.local)
    per_shard = mesh.n // n_loc  # rows this process holds, scaled to the whole mesh
    obs_chunk = _effective_chunk(int(p.obs_t.shape[0]) * per_shard, mesh.n, obs_chunk)
    imu_chunk = _effective_chunk(max(int(p.accel_t.shape[0]), int(p.gyro_t.shape[0]))
                                 * per_shard, mesh.n, imu_chunk, quantum=128)
    fam_obs, k_obs = _pad_family(_numpy_fields(p, se._obs_fields(p)), "obs_t", "obs_valid",
                                 n_loc, obs_chunk)
    fam_acc, k_acc = _pad_family(_numpy_fields(p, se._ACC_KEYS), "accel_t", "accel_valid",
                                 n_loc, imu_chunk)
    fam_gyr, k_gyr = _pad_family(_numpy_fields(p, se._GYR_KEYS), "gyro_t", "gyro_valid",
                                 n_loc, imu_chunk)
    return ((fam_obs, k_obs), (fam_acc, k_acc), (fam_gyr, k_gyr)), obs_chunk, imu_chunk


def _check_device(p: se.SplineProblem, mesh: Mesh):
    if p.obs_uv.device != mesh.device:
        raise ValueError(f"the problem lives on {p.obs_uv.device}, the mesh on {mesh.device}")


def _local_arrays(fams, d: int, device) -> dict:
    """Shard d's chunked measurement tensors."""
    return {f: torch.as_tensor(v[d], device=device) for fam in fams for f, v in fam.items()}


def _cost_of(params, p: se.SplineProblem, arrs: dict):
    """Residual-only cost of one shard's chunked measurements."""
    p_local = p._replace(**{f: v.reshape((-1,) + tuple(v.shape[2:])) for f, v in arrs.items()})
    ra, _, _ = se._accel_eval(params, p_local, with_jac=False)
    rg, _, _ = se._gyro_eval(params, p_local, with_jac=False)
    rp, _, _ = se._reproj_eval(params, p_local, with_jac=False)
    c = 0.5 * torch.sum(ra * ra) + 0.5 * torch.sum(rg * rg)
    return c + robust.huber_cost(rp.reshape(-1), se.HUBER_PX, group_size=2)


def _sum_shards(values):
    out = None
    for v in values:
        out = v if out is None else out + v
    return out


def make_sharded_fast_solver_functions_ex(p: se.SplineProblem, mesh: Mesh, axis: str = "data",
                                          obs_chunk: int = 8192, imu_chunk: int = 2048):
    """(lin2, cost2, layout, data): chunk-local dense assembly per shard
    and one sum of (H, g, cost) over the mesh; ``lin2(params, data)`` /
    ``cost2(params, data)`` take the shard data as an explicit argument.

    Measurements are split into contiguous time shards, chunk plans are
    computed per shard on the host with a shared window size, and each
    shard's linearization is the variant linearizer with its own bases
    (one kernel launch per family and shard on the card). ``p`` holds the
    rows of this process's shards: the whole problem for :func:`make_mesh`,
    the process's own time slice for a process-group mesh.
    """
    layout = se.build_layout(p)
    ((fam_obs, k_obs), (fam_acc, k_acc), (fam_gyr, k_gyr)), obs_chunk, imu_chunk = \
        _shard_families(p, mesh, obs_chunk, imu_chunk)
    ws_o, wr_o, sb_o, rb_o = _plan_family(fam_obs["obs_t"], p, obs_chunk, True, mesh)
    ws_a, wr_a, sb_a, rb_a = _plan_family(fam_acc["accel_t"], p, imu_chunk, True, mesh)
    ws_g, _, sb_g, _ = _plan_family(fam_gyr["gyro_t"], p, imu_chunk, False, mesh)

    dummy = np.zeros((1,), np.int64)
    plans = (se.ChunkPlan(k_obs, obs_chunk, ws_o, wr_o, dummy, dummy),
             se.ChunkPlan(k_acc, imu_chunk, ws_a, wr_a, dummy, dummy),
             se.ChunkPlan(k_gyr, imu_chunk, ws_g, 0, dummy, dummy))
    lin_local = se.make_fast_linearizer(p, layout, plans, include_prior=False)
    data = [(_local_arrays((fam_obs, fam_acc, fam_gyr), j, mesh.device),
             dict(obs_s=sb_o[d], obs_r=rb_o[d], acc_s=sb_a[d], acc_r=rb_a[d], gyr_s=sb_g[d]))
            for j, d in enumerate(mesh.local)]

    def lin2(params, data):
        H, g, c = (_sum_shards(x) for x in zip(*[lin_local(params, arrs, bases)
                                                for arrs, bases in data]))
        return all_reduce(H, mesh), all_reduce(g, mesh), all_reduce(c, mesh)

    def cost2(params, data):
        return all_reduce(_sum_shards(_cost_of(params, p, arrs) for arrs, _ in data), mesh)

    lin2, cost2 = _add_prior_outside(lin2, cost2, p, layout)
    return lin2, cost2, layout, data


def make_sharded_fast_solver_functions(p: se.SplineProblem, mesh: Mesh, axis: str = "data",
                                       obs_chunk: int = 8192, imu_chunk: int = 2048):
    """(linearize_fn, cost_fn, layout) with the shard data bound in a closure."""
    lin2, cost2, layout, data = make_sharded_fast_solver_functions_ex(
        p, mesh, axis, obs_chunk, imu_chunk)
    return _bind(lin2, cost2, data) + (layout,)


def make_sharded_solver_functions_ex(p: se.SplineProblem, mesh: Mesh, axis: str = "data"):
    """(lin2, cost2, layout, data) by direct block scatter-add per shard
    (the equivalence reference); same contract as
    ``se.make_solver_functions``."""
    _check_device(p, mesh)
    n_loc = len(mesh.local)
    p = pad_problem(p, n_loc)
    layout = se.build_layout(p)
    sharded, repl, static = split_problem(p)
    m = {f: v.shape[0] // n_loc for f, v in sharded.items()}
    data = [{f: v[j * m[f]:(j + 1) * m[f]] for f, v in sharded.items()} for j in range(n_loc)]

    def _fns(shard):
        return se.make_solver_functions(se.SplineProblem(**static, **shard, **repl), layout,
                                        include_prior=False)

    def lin2(params, data):
        H, g, c = (_sum_shards(x) for x in zip(*[_fns(s)[0](params) for s in data]))
        return all_reduce(H, mesh), all_reduce(g, mesh), all_reduce(c, mesh)

    def cost2(params, data):
        return all_reduce(_sum_shards(_fns(s)[1](params) for s in data), mesh)

    lin2, cost2 = _add_prior_outside(lin2, cost2, p, layout)
    return lin2, cost2, layout, data


def make_sharded_solver_functions(p: se.SplineProblem, mesh: Mesh, axis: str = "data"):
    """(linearize_fn, cost_fn, layout) with the shard data bound in a closure."""
    lin2, cost2, layout, data = make_sharded_solver_functions_ex(p, mesh, axis)
    return _bind(lin2, cost2, data) + (layout,)


def optimize_sharded(p: se.SplineProblem, params0: dict, mesh: Mesh,
                     flags: frozenset = se.DEFAULT_FLAGS, max_iters: int = 50,
                     config: lm.LMConfig | None = None, method: str = "fast",
                     obs_chunk: int = 8192, imu_chunk: int = 2048) -> lm.LMResult:
    """LM with shard-summed linearization (drop-in for se.optimize).

    method "fast" = chunk-local dense assembly per shard (production path);
    "scatter" = direct block scatter-add (equivalence reference). With a
    process-group mesh every process runs the same replicated LM on the
    reduced normal equations.
    """
    if method == "fast":
        lin2, cost2, layout, data = make_sharded_fast_solver_functions_ex(
            p, mesh, obs_chunk=obs_chunk, imu_chunk=imu_chunk)
    else:
        lin2, cost2, layout, data = make_sharded_solver_functions_ex(p, mesh)
    ref = next(iter(params0.values()))
    mask = layout.free_mask(fixed=se.flags_to_fixed(flags), dtype=ref.dtype, device=ref.device)
    cfg = config or lm.LMConfig(max_iters=max_iters, ftol=1e-4)
    return lm.lm_optimize(lambda q: lin2(q, data), lambda q: cost2(q, data), layout.retract,
                          params0, mask, cfg)
