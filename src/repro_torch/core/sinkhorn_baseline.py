"""POT-style baseline UOT: four separate passes over the coupling per iter.

The port of ``repro.core.sinkhorn_baseline`` — the paper's Figure 1
baseline, written as the same four full-matrix passes NumPy performs
(colsum, column rescale, rowsum, row rescale: 6*M*N elements of traffic
per iteration against MAP-UOT's 2*M*N). A plain oracle: it runs on the
device of its inputs.
"""
from __future__ import annotations

import torch

from repro_torch.core.problem import UOTConfig, rescale_factors


def sinkhorn_uot_baseline(A0: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          cfg: UOTConfig):
    """Run the 4-pass baseline for ``cfg.num_iters`` (or until ``cfg.tol``).

    Returns ``(A, {"iters": int, "err": float})`` where err is the final
    row-factor stationarity drift ``max|rf_t - rf_{t-1}|``.
    """
    fi = cfg.fi
    A = A0.to(cfg.dtype)
    prev_rf = torch.ones_like(a)
    err = torch.tensor(float("inf"), device=A.device)
    it = 0
    while it < cfg.num_iters and (cfg.tol is None or float(err) > cfg.tol):
        colsum = A.sum(dim=0)
        A = A * rescale_factors(b, colsum, fi)[None, :]
        rowsum = A.sum(dim=1)
        rf = rescale_factors(a, rowsum, fi)
        A = A * rf[:, None]
        err = torch.max(torch.abs(rf - prev_rf))
        prev_rf = rf
        it += 1
    return A, {"iters": it, "err": float(err)}
