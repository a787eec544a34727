"""Robust-loss weighting (IRLS) for the LM solver.

Port of ``solver/robust.py`` of the JAX package: a Huber loss applied as
iteratively reweighted least squares. Each LM linearization computes
per-residual-group weights at the current point and treats them as
constants.
"""

from __future__ import annotations

import torch


def huber_sqrt_weights(r: torch.Tensor, delta: float, group_size: int = 1) -> torch.Tensor:
    """sqrt(IRLS weight) per residual component for a Huber loss.

    Residuals are grouped into consecutive chunks of ``group_size`` (2 for
    pixel reprojection errors); the Huber loss is applied to the group
    norm. Returns a tensor shaped like ``r`` to multiply residuals (and
    Jacobian rows) by; it carries no gradient.
    """
    r = r.detach()
    g = r.reshape(-1, group_size)
    s = torch.sqrt(torch.sum(g * g, dim=-1) + 1e-20)
    w = torch.where(s <= delta, torch.ones_like(s), torch.sqrt(delta / s))
    return w.repeat_interleave(group_size).reshape(r.shape)


def huber_cost(r: torch.Tensor, delta: float, group_size: int = 1) -> torch.Tensor:
    """0.5 * sum of Huber(group norms): the true robust objective."""
    g = r.reshape(-1, group_size)
    s2 = torch.sum(g * g, dim=-1)
    s = torch.sqrt(s2 + 1e-20)
    rho = torch.where(s <= delta, s2, 2.0 * delta * s - delta * delta)
    return 0.5 * torch.sum(rho)
