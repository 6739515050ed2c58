"""Log-domain stabilized UOT solver (potentials space), dense cost only.

The port of ``repro.core.log_domain``. For small ``reg`` the Gibbs kernel
underflows in fp32; the standard fix is to iterate on dual potentials:

    f = fi * eps * (log a - logsumexp((g - C) / eps, axis=1))
    g = fi * eps * (log b - logsumexp((f - C^T) / eps, axis=0))

with eps = reg and fi = reg_m / (reg_m + reg); the coupling is
P = exp((f[:,None] + g[None,:] - C) / eps). Potentials and reductions are
computed in fp32 (or fp64 for an fp64 config); the log floor on the
marginals is the compute dtype's smallest normal number. Only the final
coupling is cast to ``cfg.dtype``.

With ``cfg.translation_invariant`` the optimal dual translation
(Séjourné et al., arXiv:2201.00730) is applied after each iteration.
This is the scheduler's containment tier (``core.health``), not a
performance tier; it runs on the device of its inputs.
"""
from __future__ import annotations

import torch


def translation_noise_floor(amplification: float, dtype: torch.dtype) -> float:
    """Magnitude below which a computed dual translation is rounding
    jitter, not signal (own copy of ``repro.core.sinkhorn_uv``'s helper):
    the translation multiplies a log-difference accurate to a few ulps by
    ``amplification``, so near the fixed point the amplified noise would
    stall a tight stationarity criterion. Translations under this floor
    are zeroed."""
    return amplification * 16 * float(torch.finfo(dtype).eps)


def sinkhorn_uot_log(C: torch.Tensor, a: torch.Tensor, b: torch.Tensor, cfg,
                     *, materialize: bool = True):
    """Log-domain UOT on a dense cost ``C`` (M, N).

    Returns ``(P, (f, g), {"iters": int, "err": float})``; ``P`` is None
    with ``materialize=False``.
    """
    eps = cfg.reg
    fi = cfg.fi
    rho = cfg.reg_m
    ti = cfg.translation_invariant and rho != float("inf")
    M, N = C.shape
    ptype = torch.promote_types(cfg.dtype, torch.float32)
    tiny = float(torch.finfo(ptype).tiny)
    C = C.to(ptype)
    loga = torch.log(torch.clamp(a.to(ptype), min=tiny))
    logb = torch.log(torch.clamp(b.to(ptype), min=tiny))
    f = torch.zeros(M, dtype=ptype, device=C.device)
    g = torch.zeros(N, dtype=ptype, device=C.device)
    floor = translation_noise_floor(0.5 * rho, ptype) if ti else 0.0
    err = torch.tensor(float("inf"), dtype=ptype, device=C.device)
    it = 0
    # the drift is read back only when a tolerance asks for it
    while it < cfg.num_iters and (cfg.tol is None or float(err) > cfg.tol):
        f_new = fi * eps * (loga - torch.logsumexp((g[None, :] - C) / eps,
                                                   dim=1))
        g_new = fi * eps * (logb - torch.logsumexp((f_new[:, None] - C) / eps,
                                                   dim=0))
        if ti:
            t = 0.5 * rho * (torch.logsumexp(loga - f_new / rho, dim=0)
                             - torch.logsumexp(logb - g_new / rho, dim=0))
            t = torch.where(torch.abs(t) > floor, t, torch.zeros_like(t))
            f_new, g_new = f_new + t, g_new - t
        err = torch.max(torch.abs(f_new - f))
        f, g = f_new, g_new
        it += 1
    stats = {"iters": it, "err": float(err)}
    if not materialize:
        return None, (f, g), stats
    P = torch.exp((f[:, None] + g[None, :] - C) / eps).to(cfg.dtype)
    return P, (f, g), stats
