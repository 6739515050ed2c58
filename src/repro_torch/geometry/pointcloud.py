"""Point-cloud squared-Euclidean geometry: cost tiles from coordinates
(PyTorch port of ``repro.geometry.pointcloud``).

For point-cloud workloads the cost ``C_ij = ||x_i - y_j||^2`` is a function
of ``O((M + N) * d)`` coordinates, so a dense ``C`` in device memory is
wasted bandwidth. This module holds the ``PointCloudGeometry`` (coordinates,
squared norms, optional per-problem valid counts for zero-padded stacks)
and the plain tile arithmetic (``pairwise_dot`` / ``cost_tile`` /
``gibbs_tile``) that the plain versions of kernels h, i, j and k evaluate.

One rounding order, everywhere. The CUDA tile function
(``kernels/csrc/uot_gibbs.cuh``) and the plain versions here compute each
entry with the same separately rounded operations in the same order:

1. the squared norms are computed once, by ``from_points``, and carried;
2. the dot over ``d`` is an unrolled elementwise chain
   ``x0*y0 + x1*y1 + ...`` (not a matrix product, whose summation order
   depends on how it is tiled);
3. ``(xn + yn) - 2*dot``, then ``/ scale`` when ``scale != 1``, then
   ``exp(-sq / reg)``, each one IEEE-rounded operation; the divisions are
   true divisions by a 0-dim tensor on the tile's device (PyTorch's CUDA
   division by a Python number multiplies by its reciprocal instead).

The CUDA source writes those operations with ``__fmul_rn`` / ``__fadd_rn``
/ ``__fsub_rn`` / ``__fdiv_rn`` and ``expf``, so nvcc contracts nothing
into an FMA, and PyTorch's separate elementwise kernels call the same
``expf``. The reference's XLA workarounds (an optimization barrier and
128-lane padding of the mirrors) have no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.geometry.base import Geometry


def sq_norms(p: torch.Tensor) -> torch.Tensor:
    """``||p_k||^2`` over the last axis, unrolled: (..., K, d) -> (..., K)."""
    n = p[..., 0] * p[..., 0]
    for k in range(1, p.shape[-1]):
        n = n + p[..., k] * p[..., k]
    return n


def pairwise_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y^T`` over the last axis as an unrolled elementwise sum:
    x (..., m, d), y (..., n, d) -> (..., m, n)."""
    out = x[..., :, 0:1] * y[..., :, 0][..., None, :]
    for k in range(1, x.shape[-1]):
        out = out + x[..., :, k:k + 1] * y[..., :, k][..., None, :]
    return out


def _div(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t / s`` as a true division on every device (rule 3 above)."""
    return t / torch.full((), s, dtype=t.dtype, device=t.device)


def cost_tile(x, xn, y, yn, *, scale: float = 1.0) -> torch.Tensor:
    """``||x_i - y_j||^2 / scale`` of a coordinate tile.

    x: (..., m, d); xn: (..., m, 1); y: (..., n, d); yn: (..., 1, n).
    """
    sq = (xn + yn) - 2.0 * pairwise_dot(x, y)
    if scale != 1.0:
        sq = _div(sq, scale)
    return sq


def gibbs_tile(x, xn, y, yn, *, reg: float, scale: float = 1.0):
    """``exp(-cost_tile / reg)``: the Gibbs-kernel tile."""
    return torch.exp(_div(-cost_tile(x, xn, y, yn, scale=scale), reg))


def valid_mask(m: int, n: int, m_valid, n_valid, device=None) -> torch.Tensor:
    """(..., m, n) bool mask of the entries inside the valid counts.

    ``m_valid`` / ``n_valid`` are ints or (...,) int tensors (one count per
    batched problem). Entries at or past a count must be exactly zero in
    any materialized kernel or coupling: that is what makes zero-padding a
    no-op for the rescaling, as zero rows / columns of a dense stack are.
    """
    rows = torch.arange(m, device=device)
    cols = torch.arange(n, device=device)
    mv = torch.as_tensor(m_valid, device=device)[..., None, None]
    nv = torch.as_tensor(n_valid, device=device)[..., None, None]
    return (rows[:, None] < mv) & (cols[None, :] < nv)


def _as_f32(t, device: torch.device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(t, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class PointCloudGeometry(Geometry):
    """Squared-Euclidean geometry of two coordinate clouds.

    Fields (a single problem; a leading batch dim on every tensor field
    gives a batched geometry, as the serving layer assembles):
      x, y:   (M, d) / (N, d) fp32 coordinates.
      xn, yn: (M,) / (N,) squared norms, computed once (use
              ``from_points`` unless you already hold them).
      m_valid, n_valid: optional per-problem valid counts (int32 scalars
              or (B,) tensors) of zero-padded stacks; rows / columns past
              them are exactly 0 in every kernel tile. ``kernel()`` and
              kernels h-k honour them; ``cost()`` and the lazy
              applications refuse masked geometries (slice the clouds
              instead: only the Gibbs kernel has a natural masked value).
      scale:  cost divisor, ``C = ||x - y||^2 / scale``.

    ``is_implicit``: kernels h, i, j and k compute this geometry's Gibbs
    tiles from the coordinates, and a serving request ships
    ``(M + N) * (d + 1)`` floats instead of ``M * N``.
    """

    x: torch.Tensor
    y: torch.Tensor
    xn: torch.Tensor
    yn: torch.Tensor
    m_valid: torch.Tensor | None = None
    n_valid: torch.Tensor | None = None
    scale: float = 1.0

    is_implicit = True

    @classmethod
    def from_points(cls, x, y, *, scale: float = 1.0, m_valid=None,
                    n_valid=None, device=None) -> "PointCloudGeometry":
        """The canonical constructor: coordinates (numpy or tensors) as
        fp32 on ``device`` (default the card), squared norms computed once
        there."""
        dev = resolve_device(device)
        x, y = _as_f32(x, dev), _as_f32(y, dev)
        if x.shape[-1] != y.shape[-1]:
            raise ValueError(f"coordinate dims differ: {tuple(x.shape)} vs "
                             f"{tuple(y.shape)}")
        count = (lambda v: None if v is None else torch.as_tensor(
            v, dtype=torch.int32, device=dev))
        return cls(x=x, y=y, xn=sq_norms(x), yn=sq_norms(y),
                   m_valid=count(m_valid), n_valid=count(n_valid),
                   scale=float(scale))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.x.shape[-2], self.y.shape[-2])

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.x.shape[:-2])

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def masked(self) -> bool:
        return self.m_valid is not None or self.n_valid is not None

    def payload_nbytes(self) -> int:
        """Bytes a serving request carrying this geometry ships:
        coordinates and squared norms, ``(M + N) * (d + 1)`` fp32 values
        per problem, against ``M * N * 4`` for the dense kernel."""
        M, N = self.shape
        batch = 1
        for dim in self.batch_shape:
            batch *= int(dim)
        return batch * 4 * (M + N) * (self.dim + 1)

    def _require_unmasked(self, what: str) -> None:
        # valid counts stand in for the zero rows / columns of a padded
        # dense stack; ignoring them here would leak the padded
        # coordinates' entries into every reduction
        if self.masked:
            raise ValueError(
                f"{what} is not defined for valid-count-masked geometries;"
                f" slice the coordinate clouds (x[:m], y[:n]) instead")

    def cost(self) -> torch.Tensor:
        """Dense ``C = ||x - y||^2 / scale`` (tests, explicit-C parity).
        Undefined for masked geometries."""
        self._require_unmasked("cost()")
        return cost_tile(self.x, self.xn[..., :, None], self.y,
                         self.yn[..., None, :], scale=self.scale)

    def batched(self) -> "PointCloudGeometry":
        """This geometry with a leading batch dim (a batch of one if it
        has none)."""
        if self.batch_shape:
            return self
        lift = (lambda t: None if t is None else t.reshape(1))
        return dataclasses.replace(
            self, x=self.x[None], y=self.y[None], xn=self.xn[None],
            yn=self.yn[None], m_valid=lift(self.m_valid),
            n_valid=lift(self.n_valid))

    def operands(self, device=None):
        """``(x, xn, y, yn, m_valid, n_valid)`` of the batched geometry on
        ``device`` (default its own), as kernels h, i, j and k take them:
        contiguous fp32 coordinates and norms, (B,) int32 valid counts.
        Nothing is padded, so only the counts are filled in: None means
        the whole problem."""
        g = self.batched()
        dev = self.device if device is None else torch.device(device)
        B, M, _ = g.x.shape
        N = g.y.shape[1]

        def counts(v, full):
            if v is None:
                return torch.full((B,), full, dtype=torch.int32, device=dev)
            return v.to(dev, torch.int32).reshape(-1).expand(B).contiguous()

        f32 = (lambda t: t.to(dev, torch.float32).contiguous())
        return (f32(g.x), f32(g.xn), f32(g.y), f32(g.yn), counts(g.m_valid, M),
                counts(g.n_valid, N))

    def kernel(self, reg: float) -> torch.Tensor:
        """The masked Gibbs kernel, fp32, on the geometry's device: kernel
        j on the card, its plain version on the CPU — one function with
        the tiles that kernels h, i and k compute. (M, N), or (B, M, N)
        for a batched geometry."""
        # kernels.uot_geometry imports this module's tile arithmetic
        from repro_torch.kernels import uot_geometry
        K = uot_geometry.batched_pc_materialize(
            *self.operands(), reg=float(reg), scale=self.scale)
        return K if self.batch_shape else K[0]

    # ---- lazy applications (u/v and log-domain solvers): row-chunked, so
    # the largest live cost tile is (chunk, N), not (M, N) ----------------

    _CHUNK = 128

    def _row_chunks(self):
        if self.batch_shape:
            raise NotImplementedError(
                "lazy applications are per problem; batched geometries are "
                "consumed by the batched solve entry points")
        self._require_unmasked("a lazy kernel / lse application")
        M = self.x.shape[0]
        return [(self.x[i:i + self._CHUNK], self.xn[i:i + self._CHUNK], i)
                for i in range(0, M, self._CHUNK)]

    def _gibbs_rows(self, xb, xnb, reg):
        return gibbs_tile(xb, xnb[:, None], self.y, self.yn[None, :],
                          reg=float(reg), scale=self.scale)

    def _cost_rows(self, xb, xnb):
        return cost_tile(xb, xnb[:, None], self.y, self.yn[None, :],
                         scale=self.scale)

    def apply_kernel(self, v: torch.Tensor, reg: float) -> torch.Tensor:
        return torch.cat([self._gibbs_rows(xb, xnb, reg) @ v
                          for xb, xnb, _ in self._row_chunks()])

    def apply_kernel_T(self, u: torch.Tensor, reg: float) -> torch.Tensor:
        return torch.stack([
            u[i:i + xb.shape[0]] @ self._gibbs_rows(xb, xnb, reg)
            for xb, xnb, i in self._row_chunks()]).sum(dim=0)

    def apply_lse(self, z: torch.Tensor, reg: float) -> torch.Tensor:
        return torch.cat([
            torch.logsumexp((z[None, :] - self._cost_rows(xb, xnb)) / reg,
                            dim=1)
            for xb, xnb, _ in self._row_chunks()])

    def apply_lse_T(self, z: torch.Tensor, reg: float) -> torch.Tensor:
        parts = [torch.logsumexp(
            (z[i:i + xb.shape[0], None] - self._cost_rows(xb, xnb)) / reg,
            dim=0) for xb, xnb, i in self._row_chunks()]
        return torch.logsumexp(torch.stack(parts), dim=0)
