"""Entropic unbalanced optimal transport problem definition (PyTorch port).

The port of ``repro.core.problem``. The entropic UOT problem between
histograms ``a`` (len M) and ``b`` (len N) with ground cost ``C`` is

    min_P  <C, P> + reg * KL(P | a b^T) + reg_m * (KL(P 1 | a) + KL(P^T 1 | b))

solved by Sinkhorn-style scaling of the Gibbs kernel K = exp(-C / reg) with
relaxation exponent ``fi = reg_m / (reg_m + reg)``. The matrix-scaling
solvers iterate directly on the coupling:

    A <- A * ((CPD / colsum(A)) ** fi)[None, :]       (column rescale)
    A <- A * ((RPD / rowsum(A)) ** fi)[:, None]       (row rescale)

Only a dense ``C`` is supported here; cost geometries (point clouds,
grids) arrive with the geometry slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class UOTConfig:
    """Configuration for an entropic UOT solve.

    Attributes:
      reg: entropic regularization epsilon.
      reg_m: marginal KL relaxation strength rho. ``float("inf")`` gives
        balanced Sinkhorn (fi == 1).
      num_iters: iteration budget (one iteration = one column + one row
        rescale).
      tol: optional early-exit tolerance on the row-factor stationarity
        drift ``max|f_t - f_{t-1}|``.
      dtype: storage dtype of the coupling matrix, ``torch.float32`` or
        ``torch.bfloat16`` (accumulation is always fp32).
      translation_invariant: apply the optimal dual translation after each
        iteration of the potential-form solver (``log_domain``; Séjourné
        et al., arXiv:2201.00730). A no-op for the matrix-form solvers.
    """

    reg: float = 0.05
    reg_m: float = 1.0
    num_iters: int = 100
    tol: float | None = None
    dtype: torch.dtype = torch.float32
    translation_invariant: bool = False

    @property
    def fi(self) -> float:
        if self.reg_m == float("inf"):
            return 1.0
        return self.reg_m / (self.reg_m + self.reg)


def gibbs_kernel(C: torch.Tensor, reg: float,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K = exp(-C / reg), the initial coupling for scaling-form solvers."""
    return torch.exp(-C / reg).to(dtype)


@dataclasses.dataclass(frozen=True)
class UOTProblem:
    """A UOT instance with a dense cost: the marginals plus ``C``."""

    a: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor

    @classmethod
    def from_cost(cls, C, a, b) -> "UOTProblem":
        return cls(a=torch.as_tensor(a), b=torch.as_tensor(b),
                   C=torch.as_tensor(C))

    @classmethod
    def from_points(cls, *args, **kwargs) -> "UOTProblem":
        raise NotImplementedError(
            "point-cloud problems arrive with the cost-geometry slice of the "
            "port (ROADMAP Open items 1, item 6)")

    @classmethod
    def from_grid(cls, *args, **kwargs) -> "UOTProblem":
        raise NotImplementedError(
            "grid problems arrive with the cost-geometry slice of the port "
            "(ROADMAP Open items 1, item 6)")

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.C.shape[-2:])

    def cost_matrix(self) -> torch.Tensor:
        return self.C

    def initial_coupling(self, reg: float,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Materialized ``K = exp(-C / reg)`` for matrix-scaling solvers."""
        return gibbs_kernel(self.C, reg, dtype)


def uot_cost(P: torch.Tensor, C: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, reg: float, reg_m: float) -> torch.Tensor:
    """Primal entropic UOT objective value (for convergence diagnostics)."""
    eps = 1e-38
    transport = torch.sum(P * C)
    ab = a[:, None] * b[None, :]
    kl_joint = torch.sum(P * (torch.log(P + eps) - torch.log(ab + eps))
                         - P + ab)
    row, col = P.sum(1), P.sum(0)
    kl_row = torch.sum(row * (torch.log(row + eps) - torch.log(a + eps))
                       - row + a)
    kl_col = torch.sum(col * (torch.log(col + eps) - torch.log(b + eps))
                       - col + b)
    return transport + reg * kl_joint + reg_m * (kl_row + kl_col)


def rescale_factors(target: torch.Tensor, sums: torch.Tensor,
                    fi: float) -> torch.Tensor:
    """(target / sums) ** fi with safe division (0/0 -> 1, i.e. no-op).

    A sum that is not positive (zero, negative or NaN) maps to factor 1,
    exactly as in the reference and in the CUDA kernels' ``safe_pow``.
    """
    pos = sums > 0
    safe = torch.where(pos, sums, torch.ones_like(sums))
    ratio = torch.where(pos, target / safe, torch.ones_like(sums))
    if fi == 1.0:
        return ratio
    return torch.pow(ratio, fi)
