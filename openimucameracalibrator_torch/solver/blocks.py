"""Parameter blocks, tangent-space layout, and retraction.

Port of ``solver/blocks.py`` of the JAX package. Quaternion blocks are
updated by right-multiplication with ``exp(delta)`` (a manifold tag);
parameter fixing is a 0/1 mask over the global tangent vector, so fixed
coordinates get zero rows/columns in the normal equations and an identity
diagonal.

Parameters are a flat ``dict[str, torch.Tensor]``. Each block has a
``BlockSpec`` describing its shape and manifold. The global tangent vector
concatenates per-block tangents in spec order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from openimucameracalibrator_torch.ops import lie


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One named parameter block.

    manifold:
      * ``euclidean`` — shape (..., d), tangent dim = prod(shape)
      * ``quat``      — shape (..., 4) unit quaternions, tangent (..., 3)
                        with retraction q ⊞ δ = q ⊗ exp(δ)
    """

    name: str
    shape: tuple
    manifold: str = "euclidean"

    @property
    def tangent_shape(self) -> tuple:
        if self.manifold == "quat":
            assert self.shape[-1] == 4, self.shape
            return self.shape[:-1] + (3,)
        return self.shape

    @property
    def tangent_size(self) -> int:
        return int(np.prod(self.tangent_shape)) if self.tangent_shape else 1


class BlockLayout:
    """Static layout of a set of blocks inside one global tangent vector."""

    def __init__(self, specs: Sequence[BlockSpec]):
        self.specs = tuple(specs)
        self.by_name = {s.name: s for s in self.specs}
        offsets = {}
        off = 0
        for s in self.specs:
            offsets[s.name] = off
            off += s.tangent_size
        self.offsets: Dict[str, int] = offsets
        self.tangent_dim: int = off

    def slice_of(self, name: str) -> slice:
        off = self.offsets[name]
        return slice(off, off + self.by_name[name].tangent_size)

    def retract(self, params: Dict[str, torch.Tensor], delta: torch.Tensor) -> Dict[str, torch.Tensor]:
        """params ⊞ delta for the full tangent vector delta (D,)."""
        out = {}
        for s in self.specs:
            d = delta[self.slice_of(s.name)].reshape(s.tangent_shape)
            p = params[s.name]
            if s.manifold == "quat":
                out[s.name] = lie.quat_boxplus(p, d.to(p.dtype))
            else:
                out[s.name] = p + d.to(p.dtype)
        return out

    def free_mask(self, fixed: Iterable[str] = (),
                  partial_masks: Dict[str, np.ndarray] | None = None, *,
                  dtype=torch.float64, device=None) -> torch.Tensor:
        """(D,) mask, 1.0 for free tangent coords, 0.0 for fixed.

        ``fixed`` names whole blocks; ``partial_masks`` maps block name to a
        0/1 array of the block's tangent shape for finer control.
        """
        fixed = set(fixed)
        mask = np.ones(self.tangent_dim, dtype=np.float64)
        for s in self.specs:
            if s.name in fixed:
                mask[self.slice_of(s.name)] = 0.0
        if partial_masks:
            for name, m in partial_masks.items():
                mask[self.slice_of(name)] = np.asarray(m, dtype=np.float64).reshape(-1)
        return torch.as_tensor(mask, dtype=dtype, device=device)

    def global_indices(self, name: str, element_idx: torch.Tensor) -> torch.Tensor:
        """Global tangent indices of element(s) of a 2D block (n_elems, td)."""
        s = self.by_name[name]
        td = s.tangent_shape[-1]
        base = self.offsets[name] + element_idx * td
        return base[..., None] + torch.arange(td, dtype=element_idx.dtype,
                                              device=element_idx.device)
