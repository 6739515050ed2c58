"""Carry configs, cost geometries and lane pools across from the JAX
reference, as numpy.

No JAX here: the reference side hands over plain fields and numpy arrays
(``np.asarray`` of each ``LaneState`` field, or a geometry's dataclass
fields), and the port hands numpy back, so a pool stepped by one package
can be continued by the other, and both packages solve the same geometry.

The two packages shape a pool differently: the reference pads to its TPU
tiling (rows to a block multiple, columns to 128), the port holds the
bucket shape exactly. Padding is exact zero coupling / marginals / column
sums and unit row factors, so converting pads or trims only that region
and refuses to trim anything else.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.problem import UOTConfig
from repro_torch.device import resolve_device
from repro_torch.geometry import (DenseGeometry, Geometry, GridGeometry,
                                  PointCloudGeometry)
from repro_torch.kernels.ops import LaneState

FIELDS = ("P", "colsum", "a", "b", "frow", "iters", "converged", "active",
          "m_valid", "n_valid", "healthy")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def config_from_fields(reg: float, reg_m: float, num_iters: int,
                       tol: float | None, dtype_name: str,
                       translation_invariant: bool = False) -> UOTConfig:
    """A port ``UOTConfig`` from the reference config's fields
    (``dtype_name`` is ``'float32'`` or ``'bfloat16'``)."""
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name must be one of {sorted(_DTYPES)}, "
                         f"got {dtype_name!r}")
    return UOTConfig(reg=float(reg), reg_m=float(reg_m),
                     num_iters=int(num_iters),
                     tol=None if tol is None else float(tol),
                     dtype=_DTYPES[dtype_name],
                     translation_invariant=bool(translation_invariant))


def _fit(x: np.ndarray, shape, fill, name: str) -> np.ndarray:
    """Pad with ``fill`` or trim ``x`` to ``shape``; trimming must only
    drop entries equal to ``fill``."""
    out = np.full(shape, fill, dtype=x.dtype)
    common = tuple(slice(0, min(s, t)) for s, t in zip(x.shape, shape))
    out[common] = x[common]
    dropped = x.copy()
    dropped[common] = fill
    if not np.all(dropped == fill):
        raise ValueError(f"cannot trim {name} {x.shape} to {shape}: the "
                         f"trimmed region is not padding")
    return out


def lane_state_from_numpy(arrays: dict, device=None, *, M: int | None = None,
                          N: int | None = None,
                          storage_dtype: torch.dtype | None = None
                          ) -> LaneState:
    """A port ``LaneState`` on ``device`` (default the card) from the 11
    reference fields as numpy. ``M`` / ``N`` (default: the arrays' own)
    set the port pool shape. ``storage_dtype`` defaults to bf16 when the
    reference pool was bf16, else fp32."""
    missing = set(FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing LaneState fields: {sorted(missing)}")
    dev = resolve_device(device)
    P = np.asarray(arrays["P"])
    L, Mr, Nr = P.shape
    M = Mr if M is None else M
    N = Nr if N is None else N
    if storage_dtype is None:
        storage_dtype = (torch.bfloat16 if P.dtype.name == "bfloat16"
                         else torch.float32)
    f32 = lambda k: np.asarray(arrays[k], np.float32)  # noqa: E731
    vecs = {
        "P": _fit(P.astype(np.float32), (L, M, N), 0.0, "P"),
        "colsum": _fit(f32("colsum"), (L, N), 0.0, "colsum"),
        "a": _fit(f32("a"), (L, M), 0.0, "a"),
        "b": _fit(f32("b"), (L, N), 0.0, "b"),
        "frow": _fit(f32("frow"), (L, M), 1.0, "frow"),
    }
    # torch.tensor copies: the port updates pools in place and must never
    # write into the caller's (possibly shared, read-only) buffers
    t = {k: torch.tensor(v, device=dev) for k, v in vecs.items()}
    t["P"] = t["P"].to(storage_dtype)
    for k in ("iters", "m_valid", "n_valid"):
        t[k] = torch.tensor(np.asarray(arrays[k], np.int32), device=dev)
    for k in ("converged", "active", "healthy"):
        t[k] = torch.tensor(np.asarray(arrays[k], bool), device=dev)
    return LaneState(**t)


def lane_state_to_numpy(state: LaneState, *, M: int | None = None,
                        N: int | None = None) -> dict:
    """The 11 fields of a port pool as numpy (the coupling in float32; a
    bf16 pool is upcast exactly), padded or trimmed to (``M``, ``N``) —
    e.g. a reference pool's shape."""
    L, Mp, Np = state.P.shape
    M = Mp if M is None else M
    N = Np if N is None else N
    host = {k: getattr(state, k).cpu() for k in FIELDS}
    return {
        "P": _fit(host["P"].float().numpy(), (L, M, N), 0.0, "P"),
        "colsum": _fit(host["colsum"].numpy(), (L, N), 0.0, "colsum"),
        "a": _fit(host["a"].numpy(), (L, M), 0.0, "a"),
        "b": _fit(host["b"].numpy(), (L, N), 0.0, "b"),
        "frow": _fit(host["frow"].numpy(), (L, M), 1.0, "frow"),
        **{k: host[k].numpy().copy()
           for k in ("iters", "converged", "active", "m_valid", "n_valid",
                     "healthy")},
    }


def geometry_from_numpy(fields: dict, device=None) -> Geometry:
    """A port geometry on ``device`` (default the card) from a reference
    geometry's dataclass fields, as numpy or anything ``np.asarray``
    takes: ``x, y, xn, yn`` (+ ``m_valid``, ``n_valid``, ``scale``) make a
    ``PointCloudGeometry`` — its squared norms carried over, not
    recomputed — ``factors`` a ``GridGeometry``, ``C`` a
    ``DenseGeometry``."""
    dev = resolve_device(device)
    f32 = (lambda v: torch.tensor(np.asarray(v, np.float32), device=dev))
    if "x" in fields:
        count = (lambda v: None if v is None else torch.tensor(
            np.asarray(v, np.int32), device=dev))
        return PointCloudGeometry(
            x=f32(fields["x"]), y=f32(fields["y"]), xn=f32(fields["xn"]),
            yn=f32(fields["yn"]), m_valid=count(fields.get("m_valid")),
            n_valid=count(fields.get("n_valid")),
            scale=float(fields.get("scale", 1.0)))
    if "factors" in fields:
        return GridGeometry(tuple(f32(C) for C in fields["factors"]))
    if "C" in fields:
        return DenseGeometry(f32(fields["C"]))
    raise ValueError(f"not a geometry's fields: {sorted(fields)}")


def geometry_to_numpy(g: Geometry) -> dict:
    """A port geometry's fields as numpy (the inverse of
    ``geometry_from_numpy``)."""
    host = (lambda t: None if t is None else t.detach().cpu().numpy())
    if isinstance(g, PointCloudGeometry):
        return {"x": host(g.x), "y": host(g.y), "xn": host(g.xn),
                "yn": host(g.yn), "m_valid": host(g.m_valid),
                "n_valid": host(g.n_valid), "scale": g.scale}
    if isinstance(g, GridGeometry):
        return {"factors": tuple(host(C) for C in g.factors)}
    if isinstance(g, DenseGeometry):
        return {"C": host(g.C)}
    raise TypeError(f"not a port geometry: {type(g).__name__}")
