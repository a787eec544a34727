"""Explicit device and precision policy.

Mirrors ``utils/precision.py`` of the JAX package: library code never
hard-codes a float type. Entry points take ``dtype=None`` and resolve it
with :func:`default_dtype` — float64 on the CPU (tests, golden
references), float32 on the card, where the solver's conditioning is kept
by the Jacobi-equilibrated Cholesky plus one refinement step
(``solver/lm.py``). Host-side numpy arrays stay float64.

Entry points also take ``device``, default ``"cuda"``: without a CUDA
device they raise instead of quietly running on the CPU; the CPU is used
only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when none is present: the
    port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        # The LM solve relies on full-fp32 products (TF32 keeps ~3 decimal
        # digits, below what the equilibrated Cholesky + refinement needs).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on the card."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def resolve(dtype, device) -> torch.dtype:
    """``dtype or default_dtype(device)``."""
    return dtype if dtype is not None else default_dtype(device)
