"""POT ``sinkhorn_knopp_unbalanced`` u/v-potential form + fused variant
(PyTorch port of ``repro.core.sinkhorn_uv``).

Semantics (POT-faithful):   u = (a / (K v)) ** fi ;  v = (b / (K^T u)) ** fi
with the Gibbs kernel K held constant and the coupling materialized only at
the end as P = diag(u) K diag(v).

Beyond-paper memory optimization (``sinkhorn_uot_uv_fused``): both matvecs
of an iteration are computed in ONE read-only pass over K. Row block i gives
(K v)_i by a row-dot; u_i is then immediately available, so u_i * K[i, :] can
be accumulated into the K^T u partials during the same pass. Traffic per
iteration: M*N element *reads*, zero writes — half of MAP-UOT's 2*M*N, and K
can be stored in bf16 (u, v and the sums stay fp32). The hand-written
kernels of that schedule are ``repro_torch.kernels.uot_uv_fused`` (one
problem) and ``uot_batched.batched_uv_iteration`` (a stack).

These are the plain solvers the kernels are held to: they run on the device
of their inputs, with a dense ``K`` upcast to fp32 (as JAX promotes a bf16
``K`` against fp32 ``v``).
"""
from __future__ import annotations

import torch

from repro_torch.core.problem import UOTConfig, rescale_factors
from repro_torch.geometry import Geometry


def _Kv(K, v, cfg: UOTConfig):
    """``K @ v`` for a dense kernel matrix or, lazily, a ``Geometry``
    (grid: per-axis contractions, never M*N; point cloud: row-chunked
    tiles)."""
    if isinstance(K, Geometry):
        return K.apply_kernel(v, cfg.reg)
    return K @ v


def _KTu(K, u, cfg: UOTConfig):
    if isinstance(K, Geometry):
        return K.apply_kernel_T(u, cfg.reg)
    return u @ K              # row-major-friendly transposed matvec


def _coupling(K, u, v, cfg: UOTConfig):
    Kd = K.kernel(cfg.reg) if isinstance(K, Geometry) else K
    return (u[:, None] * Kd * v[None, :]).to(cfg.dtype)


def _operands(K, a, b):
    """fp32 marginals, and a dense K in fp32 (a geometry as it is)."""
    if not isinstance(K, Geometry):
        K = K.float()
    return K, a.float(), b.float()


def translation_noise_floor(amplification: float, dtype: torch.dtype) -> float:
    """Magnitude below which a computed dual translation is rounding
    jitter, not signal: the translation formulas multiply a log-difference
    (accurate to a few ulps) by ``amplification`` (``rho/(2*eps)`` in
    scaling space, ``rho/2`` on potentials), so near the fixed point the
    amplified noise would sit above a tight ``tol`` forever and stall the
    stationarity stopping criterion. Translations under this floor are
    zeroed — by then TI's work (killing the mass-imbalance mode) is done
    and the plain contraction finishes the tail."""
    return amplification * 16 * float(torch.finfo(dtype).eps)


def translate_uv(u, v, a, b, eps: float, rho: float):
    """Optimal dual translation in scaling space (Séjourné et al.,
    arXiv:2201.00730, equal marginal strengths rho1 = rho2 = rho).

    In potential space f = eps*log u, g = eps*log v, translating to
    (f + t, g - t) with

        t = (rho/2) * log(<a, e^{-f/rho}> / <b, e^{-g/rho}>)

    maximizes the dual objective along the translation direction. Scaling
    space: ``u *= e^{t/eps}``, ``v /= e^{t/eps}`` — applied in log space
    because ``e^{t/eps} = (Sa/Sb)**(rho/(2*eps))`` overflows fp32 for large
    ``rho/eps`` even when the translated potentials are benign. Zero
    entries of u/v (from zero marginal mass) are left at zero, and
    sub-noise translations are zeroed via ``translation_noise_floor``.
    """
    p = eps / rho
    logu = torch.log(torch.where(u > 0, u, 1.0))
    logv = torch.log(torch.where(v > 0, v, 1.0))
    sa = torch.sum(torch.where(u > 0, a * torch.exp(-p * logu), 0.0))
    sb = torch.sum(torch.where(v > 0, b * torch.exp(-p * logv), 0.0))
    logk = rho / (2 * eps) * (torch.log(sa) - torch.log(sb))
    noise = translation_noise_floor(rho / (2 * eps), logk.dtype)
    logk = torch.where(torch.abs(logk) > noise, logk, 0.0)
    u = torch.where(u > 0, torch.exp(logu + logk), 0.0)
    v = torch.where(v > 0, torch.exp(logv - logk), 0.0)
    return u, v


def _ti_enabled(cfg: UOTConfig) -> bool:
    # Balanced problems (fi == 1) are the gauge-freedom case: translation
    # never changes P, so the extra reductions would buy nothing.
    return cfg.translation_invariant and cfg.reg_m != float("inf")


def sinkhorn_uot_uv(K, a: torch.Tensor, b: torch.Tensor, cfg: UOTConfig):
    """POT-style u/v iteration. Returns ``(P, (u, v), stats)`` with
    ``stats = {"iters": int, "err": float}``.

    ``K`` is the dense Gibbs kernel matrix — or a
    ``repro_torch.geometry.Geometry``, evaluated lazily: every matvec goes
    through ``apply_kernel`` / ``apply_kernel_T``, so a ``GridGeometry``
    iterates on per-axis factors (never forming M*N) and a
    ``PointCloudGeometry`` computes row-chunked tiles on the fly. Only the
    final coupling is dense.

    With ``cfg.tol`` the loop stops once the relative change of u,
    ``max|u_t - u_{t-1}| / |u_t|``, is at most tol (read back every
    iteration). With ``cfg.translation_invariant`` the optimal dual
    translation is applied after every iteration (``translate_uv``).
    """
    K, a, b = _operands(K, a, b)
    fi = cfg.fi
    ti = _ti_enabled(cfg)
    M, N = K.shape
    u = torch.ones(M, dtype=torch.float32, device=a.device)
    v = torch.ones(N, dtype=torch.float32, device=a.device)
    err = torch.tensor(float("inf"), device=a.device)
    it = 0
    while it < cfg.num_iters and (cfg.tol is None or float(err) > cfg.tol):
        u_new = rescale_factors(a, _Kv(K, v, cfg), fi)
        v = rescale_factors(b, _KTu(K, u_new, cfg), fi)
        if ti:
            u_new, v = translate_uv(u_new, v, a, b, cfg.reg, cfg.reg_m)
        err = torch.max(torch.abs(u_new - u)
                        / torch.clamp(torch.abs(u_new), min=1e-30))
        u = u_new
        it += 1
    return _coupling(K, u, v, cfg), (u, v), {"iters": it, "err": float(err)}


def uv_fused_iteration(K, v, a, b, fi):
    """One u/v iteration expressed as the single-read-pass computation:
    (K v, u) then (K^T u, v), where the kernels compute K @ v and
    K.T @ u in the same streaming pass."""
    u = rescale_factors(a, K @ v, fi)
    return u, rescale_factors(b, u @ K, fi)


def sinkhorn_uot_uv_fused(K, a: torch.Tensor, b: torch.Tensor,
                          cfg: UOTConfig):
    """Fused-schedule u/v solver (same iterates as ``sinkhorn_uot_uv``),
    exactly ``cfg.num_iters`` iterations. ``K`` may be a ``Geometry``
    (lazy kernel applications). Returns ``(P, (u, v), {"iters": n})``."""
    K, a, b = _operands(K, a, b)
    fi = cfg.fi
    ti = _ti_enabled(cfg)
    M, N = K.shape
    u = torch.ones(M, dtype=torch.float32, device=a.device)
    v = torch.ones(N, dtype=torch.float32, device=a.device)
    for _ in range(cfg.num_iters):
        u = rescale_factors(a, _Kv(K, v, cfg), fi)
        v = rescale_factors(b, _KTu(K, u, cfg), fi)
        if ti:
            u, v = translate_uv(u, v, a, b, cfg.reg, cfg.reg_m)
    return _coupling(K, u, v, cfg), (u, v), {"iters": cfg.num_iters}
