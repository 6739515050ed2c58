"""Problem-health checks + the log-domain escalation adapter.

The port of ``repro.core.health`` — the admission side of the scheduler's
fault containment:

- ``validate_problem`` raises a typed ``InvalidProblemError`` for requests
  that are cheap to detect before they touch device state: non-finite /
  negative / empty marginals, shape or dtype mismatches, and
  overflow-regime ``(cfg, a, b)`` combinations. O(M + N) host work; the
  M*N payload is not scanned (the stepped advance's lane-health detector
  catches non-finite payload entries in flight).
- ``uv_safe`` is the overflow-regime predicate: the scaling-space iterates
  carry the mass-imbalance mode as ``(sum(a)/sum(b)) ** (rho/(2*eps))``,
  so its log magnitude against the fp32 exponent range classifies
  problems the matrix-scaling lanes cannot represent.
- ``escalate_log_solve`` re-solves a quarantined request once on
  ``sinkhorn_uot_log`` from ``C = -reg * log(K)`` with an escalated
  iteration budget. The answer has the potential-form damping semantics,
  which is why schedulers mark it ``retried_ok`` rather than ``ok``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.log_domain import sinkhorn_uot_log
from repro_torch.core.problem import UOTConfig
from repro_torch.device import resolve_device


class InvalidProblemError(ValueError):
    """A request refused at admission, with a machine-readable reason.

    ``reason`` is one of: ``'shape'``, ``'dtype'``, ``'non_finite'``,
    ``'negative'``, ``'empty'``, ``'uv_overflow'``. ``rid`` is the request
    id the scheduler assigned before refusing, or None outside a scheduler.
    """

    def __init__(self, reason: str, message: str, *, rid: int | None = None):
        super().__init__(message)
        self.reason = reason
        self.rid = rid


def uv_amplification_log(cfg: UOTConfig, a, b) -> float:
    """log-magnitude ``rho/(2*eps) * |log Sa - log Sb|`` of the
    scaling-space mass-imbalance factor; 0 for balanced problems
    (``reg_m=inf``), +inf for empty or non-finite marginals."""
    sa = float(np.sum(a))
    sb = float(np.sum(b))
    if not (sa > 0.0 and sb > 0.0) or not math.isfinite(sa + sb):
        return math.inf
    rho, eps = cfg.reg_m, cfg.reg
    if rho == math.inf:
        return 0.0
    return rho / (2.0 * eps) * abs(math.log(sa) - math.log(sb))


def uv_safe(cfg: UOTConfig, a, b, *, dtype: torch.dtype = torch.float32,
            margin: float = 0.5) -> bool:
    """True when the scaling-space tiers can represent this problem's
    mass-imbalance mode in ``dtype``: ``uv_amplification_log`` against
    ``margin * log(finfo(dtype).max)``."""
    ceiling = margin * math.log(float(torch.finfo(dtype).max))
    return uv_amplification_log(cfg, a, b) <= ceiling


def validate_problem(cfg: UOTConfig, a, b, *,
                     shape: tuple[int, int] | None = None,
                     rid: int | None = None,
                     check_overflow: bool = True) -> None:
    """Raise ``InvalidProblemError`` for requests that would poison a lane.

    O(M + N): marginals only. ``shape`` (M, N), when given, is the payload
    shape the marginals must match.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    for name, v in (("a", a), ("b", b)):
        if v.ndim != 1:
            raise InvalidProblemError(
                "shape", f"marginal {name} must be 1-D, got shape "
                f"{v.shape}", rid=rid)
        if not np.issubdtype(v.dtype, np.floating):
            raise InvalidProblemError(
                "dtype", f"marginal {name} must be floating, got "
                f"{v.dtype}", rid=rid)
        if not np.all(np.isfinite(v)):
            raise InvalidProblemError(
                "non_finite", f"marginal {name} has non-finite entries",
                rid=rid)
        if np.any(v < 0):
            raise InvalidProblemError(
                "negative", f"marginal {name} has negative entries",
                rid=rid)
        if not np.sum(v) > 0:
            raise InvalidProblemError(
                "empty", f"marginal {name} has zero total mass", rid=rid)
    if shape is not None:
        M, N = shape
        if a.shape != (M,) or b.shape != (N,):
            raise InvalidProblemError(
                "shape", f"marginals ({a.shape[0]},)/({b.shape[0]},) do "
                f"not match problem shape ({M}, {N})", rid=rid)
    if check_overflow and not uv_safe(cfg, a, b):
        raise InvalidProblemError(
            "uv_overflow",
            f"(cfg, a, b) is in the scaling-space overflow regime "
            f"(amplification log {uv_amplification_log(cfg, a, b):.1f} "
            f"exceeds the fp32 budget) — this problem belongs to the "
            f"log-domain tier", rid=rid)


def escalation_config(cfg: UOTConfig, *, factor: int = 2,
                      num_iters: int | None = None) -> UOTConfig:
    """The escalated config a quarantined request retries under: same
    (reg, reg_m) problem, a larger iteration budget, fp32 math."""
    iters = num_iters if num_iters is not None else factor * cfg.num_iters
    return dataclasses.replace(cfg, num_iters=iters, dtype=torch.float32)


def escalate_log_solve(K, a, b, cfg: UOTConfig, *, factor: int = 2,
                       num_iters: int | None = None, device=None):
    """Re-solve a quarantined request on ``sinkhorn_uot_log``.

    ``K`` is the request's stored Gibbs matrix; the log solve runs from
    ``C = -reg * log(K)`` on ``device`` (default the card). Entries with
    ``K <= 0`` map to an effectively infinite cost; non-finite entries stay
    NaN so a poisoned payload comes back not-ok.

    Returns ``(P numpy, stats, ok)`` with ``ok`` True iff the coupling is
    all-finite. The solve never raises on bad numerics.
    """
    dev = resolve_device(device)
    ecfg = escalation_config(cfg, factor=factor, num_iters=num_iters)
    K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    tiny = float(torch.finfo(torch.float32).tiny)
    C = -ecfg.reg * torch.log(torch.clamp(K, min=tiny))
    C = torch.where(torch.isfinite(K), C, torch.full_like(C, float("nan")))
    P, _, stats = sinkhorn_uot_log(
        C, torch.as_tensor(np.asarray(a, np.float32), device=dev),
        torch.as_tensor(np.asarray(b, np.float32), device=dev), ecfg)
    P = P.cpu().numpy()
    ok = bool(np.all(np.isfinite(P)))
    return P, {"iters": stats["iters"], "err": stats["err"],
               "num_iters": ecfg.num_iters}, ok
