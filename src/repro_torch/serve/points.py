"""The payload of a point-cloud serving request, shared by the flush
engine and the scheduler: host coordinates with their squared norms
(``point_payload``), and a round's requests staged on the device as one
batched ``PointCloudGeometry`` with per-problem valid counts
(``stage_points``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.geometry import PointCloudGeometry
from repro_torch.geometry.pointcloud import sq_norms
from repro_torch.kernels import ops


def point_payload(x, y):
    """Host coordinates of a point request as fp32 numpy, with their
    squared norms computed once (the geometry's rule). Raises
    ``ValueError`` for clouds that are not (M, d) / (N, d) of one d."""
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"coordinate dims differ: {x.shape} vs {y.shape} "
                         f"(need (M, d) and (N, d))")
    return (x, y, sq_norms(torch.from_numpy(x)).numpy(),
            sq_norms(torch.from_numpy(y)).numpy())


def stage_points(reqs, B: int, Mb: int, Nb: int, scale: float, device):
    """Point requests zero-padded to (Mb, Nb) and stacked B high (slots past
    ``len(reqs)`` are empty problems): a batched ``PointCloudGeometry``
    with per-problem valid counts, and the (B, Mb) / (B, Nb) marginals, on
    ``device``. Everything is assembled in one host buffer and crosses to
    the device in one pinned copy."""
    d = reqs[0].x.shape[1]
    shapes = ((B, Mb, d), (B, Mb), (B, Nb, d), (B, Nb), (B, Mb), (B, Nb),
              (B,), (B,))
    sizes = [int(np.prod(sh)) for sh in shapes]
    buf = np.zeros(sum(sizes), np.float32)
    x, xn, y, yn, a, b, mv, nv = (
        v.reshape(sh) for v, sh in zip(np.split(buf, np.cumsum(sizes)[:-1]),
                                       shapes))
    for k, r in enumerate(reqs):
        M, N = r.shape
        x[k, :M], xn[k, :M], a[k, :M] = r.x, r.xn, r.a
        y[k, :N], yn[k, :N], b[k, :N] = r.y, r.yn, r.b
        mv[k], nv[k] = M, N
    t = ops.to_device(buf, device)
    x, xn, y, yn, a, b, mv, nv = (
        v.reshape(sh) for v, sh in zip(torch.split(t, sizes), shapes))
    geom = PointCloudGeometry(x=x, y=y, xn=xn, yn=yn,
                              m_valid=mv.to(torch.int32),
                              n_valid=nv.to(torch.int32), scale=scale)
    return geom, a, b
