"""Multi-process launch: torch.distributed init + per-process measurement loading.

Port of ``parallel/multihost.py`` of the JAX package:

* :func:`initialize` joins a ``torch.distributed`` group over
  ``tcp://{coordinator_address}`` (NCCL on CUDA, gloo on the CPU; each rank
  on ``cuda:{local rank}``). It is a no-op on a single process, so every
  CLI can call it unconditionally.
* :func:`global_mesh` is a mesh of one shard per process: the summed
  normal equations of ``parallel/sharded.py`` and the separator reduction
  of ``parallel/schur.py`` then all-reduce across processes, with the same
  code as the shards of one process.
* :func:`host_shard` / :func:`make_global_problem` implement per-process
  data loading: each process reads ONLY its contiguous time slice of the
  measurement arrays, and no process ever holds the full recording.

Nothing here falls back: a group that does not form raises when its
timeout expires.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict

import numpy as np
import torch

from openimucameracalibrator_torch.core import spline_estimator as se
from openimucameracalibrator_torch.parallel.sharded import Mesh, _indexed
from openimucameracalibrator_torch.utils import precision

_DEVICE = None  # this process's device once initialize() has joined a group


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None, device=None,
               timeout_s: float = 300.0) -> bool:
    """Join a multi-process group; returns True when one was joined.

    No-op (returns False) without a coordinator: neither
    ``coordinator_address`` nor the ``COORDINATOR_ADDRESS`` environment
    variable (with ``NUM_PROCESSES`` and ``PROCESS_ID``). ``device``
    (default ``"cuda"``) picks the rank's device: ``cuda:{local rank}``,
    the local rank being ``LOCAL_RANK`` or ``process_id`` modulo the
    visible GPUs. ``backend`` defaults to ``"nccl"`` on CUDA and ``"gloo"``
    on the CPU (NCCL takes one rank per GPU; several ranks on one GPU need
    ``backend="gloo"``). Joining waits at most ``timeout_s`` for the other
    ranks and raises then.
    """
    global _DEVICE
    if coordinator_address is None and "COORDINATOR_ADDRESS" not in os.environ:
        return False
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ["COORDINATOR_ADDRESS"]
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is outside [0, {num_processes})")
    dev = precision.resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id)) % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != num_processes or dist.get_rank() != process_id:
            raise RuntimeError("a different process group is already initialized")
        return True
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return True


def _group():
    import torch.distributed as dist

    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _group() is not None else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _group() is not None else 1


def global_mesh(axis: str = "data", device=None) -> Mesh:
    """One shard per process of the group (one shard on ``device``, default
    ``"cuda"``, when no group was joined)."""
    if _group() is None:
        return Mesh(n=1, local=(0,), device=_indexed(precision.resolve_device(device)), axis=axis)
    return Mesh(n=process_count(), local=(process_index(),), device=_DEVICE, group=_group(),
                axis=axis)


def host_time_range(t_lo: float, t_hi: float, process_id: int | None = None,
                    num_processes: int | None = None) -> tuple:
    """Contiguous time slice [lo, hi) owned by this process.

    Time (not index) partitioning keeps every process's knot windows local,
    the same property the knot-sharded Schur solver relies on.
    """
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    span = (t_hi - t_lo) / n
    return t_lo + pid * span, t_hi if pid == n - 1 else t_lo + (pid + 1) * span


def host_shard(times: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Boolean mask of the samples this process loads (times sorted)."""
    t = np.asarray(times)
    return (t >= lo) & (t < hi)


def make_global_array(local_rows: np.ndarray, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This process's rows of a leading-axis-sharded array, on the mesh's
    device: each process passes ONLY its own rows (its time slice, padded
    by the caller to the common per-process length) and holds only those.
    Floats take the device's default dtype (float64 on the CPU, float32 on
    the card), booleans stay boolean, integers become int64."""
    a = (local_rows.cpu().numpy() if isinstance(local_rows, torch.Tensor)
         else np.asarray(local_rows))
    if a.dtype == bool:
        return torch.as_tensor(a, device=mesh.device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=mesh.device)
    return torch.as_tensor(a, dtype=precision.default_dtype(mesh.device), device=mesh.device)


def pad_rows(x: np.ndarray, target: int, pad_value=0) -> np.ndarray:
    out = np.full((target,) + x.shape[1:], pad_value, dtype=x.dtype)
    out[:x.shape[0]] = x
    return out


def _fam_of(field: str) -> str:
    return ("accel" if field.startswith("accel")
            else "gyro" if field.startswith("gyro") else "obs")


def agree_per_host_rows(local: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Agreement across processes on the common per-process row count per
    family: an ``all_gather`` of every process's counts, then the
    per-family max. Single process: this process's own counts."""
    fams = sorted({_fam_of(f) for f in local})
    counts = {fam: max((v.shape[0] for f, v in local.items() if _fam_of(f) == fam), default=0)
              for fam in fams}
    if _group() is None:
        return counts
    import torch.distributed as dist

    dev = _DEVICE if dist.get_backend() == "nccl" else torch.device("cpu")
    vec = torch.tensor([counts[fam] for fam in fams], dtype=torch.int64, device=dev)
    out = [torch.empty_like(vec) for _ in range(process_count())]
    dist.all_gather(out, vec)
    all_counts = torch.stack(out).cpu().numpy()
    return {fam: int(all_counts[:, i].max()) for i, fam in enumerate(fams)}


def make_global_problem(local: Dict[str, np.ndarray], meta: Dict, mesh: Mesh,
                        axis: str = "data", per_host_rows: Dict[str, int] | None = None
                        ) -> se.SplineProblem:
    """A SplineProblem holding this process's time slice of the measurement
    arrays, for a process-group mesh (``parallel/sharded.py`` and
    ``parallel/schur.py`` take it as the process's rows).

    ``local``: this process's measurement rows (accel_t/accel_meas/...,
    gyro_*, obs_*) for ITS time slice only, with *_valid marking real rows.
    ``meta``: the static SplineProblem fields (t0, dt_*, n_*, w_accel,
    w_gyro, cam_params, model_name, rolling_shutter). ``per_host_rows``:
    common per-process row count per family; when omitted it is agreed
    across processes with :func:`agree_per_host_rows`. Padding rows are
    invalid and repeat the slice's last time (the JAX package pads times
    with 0), which keeps each process's chunk windows local.
    """
    if per_host_rows is None:
        per_host_rows = agree_per_host_rows(local)
    arrays = {}
    for f, v in local.items():
        v = np.asarray(v)
        target = per_host_rows.get(_fam_of(f), v.shape[0])
        pad_value = False if f.endswith("_valid") else 0
        if f.endswith("_t") and v.shape[0]:
            pad_value = v[-1]
        arrays[f] = make_global_array(pad_rows(v, target, pad_value), mesh, axis)
    meta = {k: (make_global_array(v, mesh, axis)
                if isinstance(v, (np.ndarray, torch.Tensor, list)) else v)
            for k, v in meta.items()}
    return se.SplineProblem(**meta, **arrays)

