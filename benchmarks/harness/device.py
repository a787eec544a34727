"""The card a run uses: presence, name, power limit, clocks, memory."""

from __future__ import annotations

import subprocess
import sys


def require_cuda(chips: int):
    """Exit with code 3 (and no result) unless ``chips`` CUDA devices are
    there: a measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        raise SystemExit(3)


def smi(query: str) -> list[str]:
    """``nvidia-smi --query-gpu=<query>`` for each card, as strings; [] when
    nvidia-smi cannot be run."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.strip().splitlines()]


def kind(dev: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"


def info(chips: int, dev: str = "cuda") -> dict:
    """The result line's ``device``: on the card its name, the cards used,
    the peak allocated memory of the fullest one and its power limit."""
    import torch

    if dev != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    limits = smi("power.limit")
    return {"platform": "gpu", "kind": kind(dev), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(chips)),
            "power_limit": limits[0] if limits else "not read"}


def log_clocks(label: str):
    """One stderr line with the cards' SM clock, power draw and limit and
    temperature, sampled now."""
    rows = smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"clocks {label}: " + ("; ".join(rows) if rows else "nvidia-smi not read"),
          file=sys.stderr, flush=True)
