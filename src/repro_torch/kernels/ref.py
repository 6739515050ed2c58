"""Plain oracles for the streamed kernels (the port of the dense half of
``repro.kernels.ref``). Out of place and in fp32: the allclose targets of
the tests."""
from __future__ import annotations

import torch

from repro_torch.core.problem import rescale_factors


def colsum_ref(A):
    """Oracle for ``uot_fused.colsum``: (M, N) -> (N,) fp32."""
    return A.float().sum(dim=0)


def fused_iteration_ref(A, factor_col, a, *, fi: float):
    """One Algorithm-1 pass on one problem: returns (A', colsum')."""
    A = A.float() * factor_col.float()[None, :]
    frow = rescale_factors(a.float(), A.sum(dim=1), fi)
    A = A * frow[:, None]
    return A, A.sum(dim=0)


def batched_fused_iteration_ref(A, factor_col, a, *, fi: float):
    """Oracle for ``uot_batched.batched_fused_iteration``: the
    single-problem oracle over a stack."""
    outs = [fused_iteration_ref(A[i], factor_col[i], a[i], fi=fi)
            for i in range(A.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def batched_colsum_ref(A):
    return A.float().sum(dim=1)
