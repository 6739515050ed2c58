"""Cost geometries (PyTorch port of ``repro.geometry``): name the cost
*source*, not its M*N bytes.

- ``DenseGeometry(C)`` — the explicit matrix.
- ``PointCloudGeometry.from_points(x, y)`` — the squared-Euclidean cost of
  coordinate clouds; kernels h, i, j and k compute its Gibbs tiles on the
  card from ``O((M + N) * d)`` coordinates, and serving ships coordinates
  instead of matrices.
- ``GridGeometry(factors)`` — separable per-axis costs; kernel
  applications are small per-axis contractions.

The reference's ``sliced`` (sliced UOT over 1-D projections) is not here
yet: it needs the exact 1-D solver, which comes with the overload slice.
"""
from repro_torch.geometry.base import Geometry
from repro_torch.geometry.dense import DenseGeometry
from repro_torch.geometry.grid import GridGeometry
from repro_torch.geometry.pointcloud import PointCloudGeometry

__all__ = ["Geometry", "DenseGeometry", "GridGeometry", "PointCloudGeometry"]
