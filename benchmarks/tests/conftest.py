"""Tiny cells for the benchmark's CPU tests, and the card fixture."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmarks.harness import cell as cell_mod  # noqa: E402

# Each cell's traffic cut to what the CPU runs in seconds: fewer views and
# frames, 10 fps and a 100 Hz IMU for the recordings, and no warm item.
TINY = {
    "calibrate": dict(duration_s=6.0, intrinsics_views=16, warm_items=0),
    "batch4": dict(durations_s=[6.0, 5.0, 5.5, 6.0], warm_items=0),
    "detect": dict(pool_frames=8, batch_frames=4),
}
TINY_RATES = dict(cam_fps=10.0, imu_rate=100.0)


def tiny_cell(name: str, seed: int = 2**31 + 5, variant: str = "") -> cell_mod.Cell:
    """The cell ``name`` of BENCHMARK.json at a CPU size, on the CPU."""
    c = cell_mod.load(name, seed, device="cpu")
    traffic = name.split(".", 1)[1]
    c.traffic.update(TINY[traffic])
    if traffic != "detect":
        c.config.update(TINY_RATES)
    c.variant = variant
    return c


@pytest.fixture
def card():
    """Skips the test without a CUDA device (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m cuda benchmarks/tests` "
                    "on the card")
    return "cuda"
