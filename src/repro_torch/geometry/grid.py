"""Separable grid geometry: per-axis cost factors, never an M*N array
(PyTorch port of ``repro.geometry.grid``).

For histograms on product grids (images, voxel grids) with a separable
ground cost ``C[(i_1..i_k), (j_1..j_k)] = sum_l C_l[i_l, j_l]`` the Gibbs
kernel is a Kronecker product, ``K = kron(K_1, ..., K_k)`` with
``K_l = exp(-C_l / reg)``, and each kernel application the u/v and
log-domain solvers need is a sequence of small per-axis contractions
(``torch.tensordot``, staged ``torch.logsumexp``) with ``O(M + N)`` state.
``kernel()`` / ``cost()`` are materializing mirrors for tests and for the
matrix-scaling solvers, which iterate on a dense coupling. No TPU kernel
exists for this geometry, so nothing here is a kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.geometry.base import Geometry


@dataclasses.dataclass(frozen=True)
class GridGeometry(Geometry):
    """Geometry of a separable cost over a k-axis product grid.

    ``factors`` are the per-axis cost matrices ``C_l`` of shape
    ``(m_l, n_l)``; the flattened problem is ``(prod m_l, prod n_l)`` with
    row-major flattening of the grid axes, as ``torch.reshape`` does.
    """

    factors: tuple

    def __post_init__(self):
        if not self.factors:
            raise ValueError("GridGeometry needs at least one axis factor")
        object.__setattr__(self, "factors", tuple(self.factors))

    @property
    def grid_shape(self) -> tuple[tuple[int, int], ...]:
        return tuple(tuple(C.shape) for C in self.factors)

    @property
    def shape(self) -> tuple[int, int]:
        return (math.prod(C.shape[0] for C in self.factors),
                math.prod(C.shape[1] for C in self.factors))

    def cost(self) -> torch.Tensor:
        """Dense kron-sum mirror."""
        C = self.factors[0]
        for Cn in self.factors[1:]:
            C = (C[:, None, :, None] + Cn[None, :, None, :]).reshape(
                C.shape[0] * Cn.shape[0], C.shape[1] * Cn.shape[1])
        return C

    def kernel(self, reg: float) -> torch.Tensor:
        """Dense Kronecker mirror ``kron(exp(-C_l / reg))``."""
        K = torch.exp(-self.factors[0] / reg)
        for Cn in self.factors[1:]:
            Kn = torch.exp(-Cn / reg)
            K = (K[:, None, :, None] * Kn[None, :, None, :]).reshape(
                K.shape[0] * Kn.shape[0], K.shape[1] * Kn.shape[1])
        return K

    def _apply(self, vec, reg, *, transpose: bool) -> torch.Tensor:
        axis_in = 0 if transpose else 1
        V = vec.reshape(tuple(C.shape[axis_in] for C in self.factors))
        for axis, C in enumerate(self.factors):
            K = torch.exp(-C / reg)
            if transpose:
                K = K.T
            # contract axis ``axis`` of V against K's input axis and put the
            # output axis back in place: one small matmul per grid axis
            V = torch.movedim(torch.tensordot(K, V, dims=([1], [axis])), 0,
                              axis)
        return V.reshape(-1)

    def apply_kernel(self, v: torch.Tensor, reg: float) -> torch.Tensor:
        return self._apply(v, float(reg), transpose=False)

    def apply_kernel_T(self, u: torch.Tensor, reg: float) -> torch.Tensor:
        return self._apply(u, float(reg), transpose=True)

    def _apply_lse(self, z, reg, *, transpose: bool) -> torch.Tensor:
        axis_in = 0 if transpose else 1
        W = z.reshape(tuple(C.shape[axis_in] for C in self.factors)) / reg
        for axis, C in enumerate(self.factors):
            A = -C / reg
            if transpose:
                A = A.T
            Wf = torch.movedim(W, axis, 0)           # (in_l, rest...)
            comb = A[(...,) + (None,) * (Wf.dim() - 1)] + Wf[None]
            W = torch.movedim(torch.logsumexp(comb, dim=1), 0, axis)
        return W.reshape(-1)

    def apply_lse(self, z: torch.Tensor, reg: float) -> torch.Tensor:
        return self._apply_lse(z, float(reg), transpose=False)

    def apply_lse_T(self, z: torch.Tensor, reg: float) -> torch.Tensor:
        return self._apply_lse(z, float(reg), transpose=True)
