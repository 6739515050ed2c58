"""Cost geometry abstraction: where the ground cost comes from (PyTorch port
of ``repro.geometry.base``).

Every solver consumes the ground cost ``C`` or its Gibbs kernel
``K = exp(-C / reg)`` somewhere: the matrix-scaling solvers start from
``K`` as the initial coupling, the u/v and log-domain solvers apply ``K``
(or the ``(z - C) / reg`` logsumexps) every iteration. A ``Geometry`` names
the cost *source* instead of its materialization, so each consumer picks
the cheapest faithful evaluation: load a dense tile, compute the tile on
the card from coordinates, or contract small per-axis factors.

Three backends (the sibling modules):

- ``DenseGeometry`` — an explicit ``C``; the degenerate case.
- ``PointCloudGeometry`` — the squared-Euclidean cost of ``(M, d)`` /
  ``(N, d)`` coordinate clouds. ``is_implicit``: kernels h, i, j and k
  compute its Gibbs tiles from the coordinates, so no ``M*N`` cost array
  exists in device memory on that path.
- ``GridGeometry`` — a separable cost over a product grid; kernel
  applications are per-axis contractions of small factors.

The geometries are plain frozen dataclasses of tensors; each tensor keeps
the device it was made on, and the solvers move coordinates to their own
device.
"""
from __future__ import annotations

import torch


class Geometry:
    """Abstract cost source of an (M, N) transport problem.

    Subclasses implement the materializing mirrors (``cost``, ``kernel``)
    and the lazy applications (``apply_kernel``, ``apply_kernel_T``,
    ``apply_lse``, ``apply_lse_T``). ``is_implicit`` marks geometries whose
    Gibbs tiles the kernels compute from O(M + N) operands instead of
    loading an M*N array.
    """

    is_implicit: bool = False

    @property
    def shape(self) -> tuple[int, int]:
        """(M, N) of one problem (batched geometries report the trailing
        per-problem shape)."""
        raise NotImplementedError

    @property
    def batch_shape(self) -> tuple[int, ...]:
        """Leading batch dims (() for a single problem)."""
        return ()

    def cost(self) -> torch.Tensor:
        """The dense cost matrix C (tests and explicit-C parity)."""
        raise NotImplementedError

    def kernel(self, reg: float) -> torch.Tensor:
        """The Gibbs kernel ``K = exp(-C / reg)``, materialized: what the
        dense solver tiers consume."""
        raise NotImplementedError

    def apply_kernel(self, v: torch.Tensor, reg: float) -> torch.Tensor:
        """``K @ v`` without holding a dense K."""
        raise NotImplementedError

    def apply_kernel_T(self, u: torch.Tensor, reg: float) -> torch.Tensor:
        """``K^T @ u`` without holding a dense K."""
        raise NotImplementedError

    def apply_lse(self, z: torch.Tensor, reg: float) -> torch.Tensor:
        """``logsumexp_j((z_j - C_ij) / reg)`` per row."""
        raise NotImplementedError

    def apply_lse_T(self, z: torch.Tensor, reg: float) -> torch.Tensor:
        """``logsumexp_i((z_i - C_ij) / reg)`` per column."""
        raise NotImplementedError
