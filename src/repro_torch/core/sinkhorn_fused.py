"""MAP-UOT fused iteration (paper Algorithm 1) — plain PyTorch semantics.

The port of ``repro.core.sinkhorn_fused``: the semantic reference the
kernels are held to. The column sums for iteration t+1's column rescale
are carried out of iteration t's row rescale, so each iteration touches
the coupling once (read + write 2*M*N elements):

    factor_col = (CPD / carried_colsum) ** fi        # O(N)
    A *= factor_col;  s = rowsum(A)                   # computations I, II
    factor_row = (RPD / s) ** fi                      # O(M)
    A *= factor_row;  carried_colsum = colsum(A)      # computations III, IV

These are plain oracles: they run on the device of their inputs, in
whatever order PyTorch sums.
"""
from __future__ import annotations

import torch

from repro_torch.core.problem import UOTConfig, rescale_factors


def fused_iteration(A, colsum, a, b, fi):
    """One MAP-UOT iteration given carried column sums;
    returns (A', colsum', factor_row). Works on (M, N) or (B, M, N)."""
    factor_col = rescale_factors(b, colsum, fi)
    A = A * factor_col.unsqueeze(-2)           # computation I
    rowsum = A.sum(dim=-1)                     # computation II
    factor_row = rescale_factors(a, rowsum, fi)
    A = A * factor_row.unsqueeze(-1)           # computation III
    return A, A.sum(dim=-2), factor_row        # computation IV


def sinkhorn_uot_fused(A0: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       cfg: UOTConfig):
    """MAP-UOT solver: Algorithm 1 for ``cfg.num_iters`` (or ``cfg.tol``).

    Returns ``(A, {"iters", "err", "colsum"})``.
    """
    A, stats = sinkhorn_uot_fused_batched(A0[None], a[None], b[None], cfg)
    return A[0], {"iters": int(stats["iters"][0]),
                  "err": float(stats["err"][0]),
                  "colsum": stats["colsum"][0]}


def sinkhorn_uot_fused_batched(A0: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor, cfg: UOTConfig):
    """Batched Algorithm 1: A0 (B, M, N), a (B, M), b (B, N).

    Each lane stops on its own: with ``cfg.tol`` a lane whose factor drift
    falls to tol keeps the iterate it had then (the semantics of the
    reference's ``vmap`` of a ``while_loop``). Returns ``(A, stats)`` with
    per-lane ``iters`` (int64) and ``err`` (the final drift) and the
    carried ``colsum``.
    """
    fi = cfg.fi
    A = A0.to(cfg.dtype)
    B = A.shape[0]
    colsum = A.sum(dim=1)      # "preprocessed" init of Factor_col (Alg. 1)
    prev_rf = torch.ones_like(a)
    iters = torch.zeros(B, dtype=torch.int64, device=A.device)
    err = torch.full((B,), float("inf"), device=A.device)
    for _ in range(cfg.num_iters):
        live = (err > cfg.tol) if cfg.tol is not None else None
        if live is not None and not bool(live.any()):
            break
        A_n, colsum_n, rf = fused_iteration(A, colsum, a, b, fi)
        err_n = torch.amax(torch.abs(rf - prev_rf), dim=-1)
        if live is None:
            A, colsum, prev_rf, err = A_n.to(A.dtype), colsum_n, rf, err_n
            iters += 1
            continue
        A = torch.where(live[:, None, None], A_n.to(A.dtype), A)
        colsum = torch.where(live[:, None], colsum_n, colsum)
        prev_rf = torch.where(live[:, None], rf, prev_rf)
        err = torch.where(live, err_n, err)
        iters += live.to(torch.int64)
    return A, {"iters": iters, "err": err, "colsum": colsum}
