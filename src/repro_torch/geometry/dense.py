"""Explicit dense cost matrix: the degenerate Geometry backend (PyTorch port
of ``repro.geometry.dense``).

Wraps a precomputed ``C`` so every solver entry point can take a
``Geometry`` uniformly; semantics and bytes moved are the dense path's.
The reference evaluates ``exp`` on a 128-lane padded copy to match XLA's
vector code bit for bit; PyTorch's ``exp`` is the same function on every
element, so there is no padding here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.geometry.base import Geometry


@dataclasses.dataclass(frozen=True)
class DenseGeometry(Geometry):
    """Geometry backed by an explicit (M, N) (or (..., M, N)) cost."""

    C: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.C.shape[-2:])

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.C.shape[:-2])

    def cost(self) -> torch.Tensor:
        return self.C

    def kernel(self, reg: float) -> torch.Tensor:
        return torch.exp(-self.C / reg)

    def apply_kernel(self, v: torch.Tensor, reg: float) -> torch.Tensor:
        return self.kernel(reg) @ v

    def apply_kernel_T(self, u: torch.Tensor, reg: float) -> torch.Tensor:
        return u @ self.kernel(reg)

    def apply_lse(self, z: torch.Tensor, reg: float) -> torch.Tensor:
        return torch.logsumexp((z[None, :] - self.C) / reg, dim=1)

    def apply_lse_T(self, z: torch.Tensor, reg: float) -> torch.Tensor:
        return torch.logsumexp((z[:, None] - self.C) / reg, dim=0)
