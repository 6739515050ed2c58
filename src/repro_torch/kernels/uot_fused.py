"""Single-problem MAP-UOT kernels a and b: CUDA wrappers and plain versions.

The port of ``repro.kernels.uot_fused``'s ``colsum`` (kernel a) and
``fused_iteration`` (kernel b), the streamed pass behind
``ops.solve_fused``. Each wrapper takes the plain PyTorch version beside it
for tensors on the CPU, launches the hand-written CUDA kernel
(``csrc/uot_fused.cu``, built at first use) for tensors on the card, and
raises for anything else. There is no fallback from the card to the plain
version.

What differs from the TPU kernels (notes in the CUDA source):

* ``fused_iteration`` updates the coupling **in place**: ``A'`` is written
  over ``A``, so a solve holds one M*N buffer;
* no padding: the kernels mask ragged M and N edges;
* the TPU kernels carry the column sums in one accumulator that sequential
  grid steps revisit; here each block writes partial column sums and a
  second launch in the same wrapper call adds them in a fixed order, so
  a launch gives the same bits on every run. The device code is that of
  kernels c and d at B=1 (``csrc/uot_stream.cuh``), with their launch
  plans (``uot_batched.plan_colsum``, ``plan_for``); one problem has no
  batch to fill the card with, so the grids are cut from the problem's own
  rows (and, for kernel a, its columns).

``LAUNCHES`` counts kernel launches per wrapper (one per wrapper call on
the card) and ``PLAIN_CALLS`` plain-version calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import uot_batched as ub
from repro_torch.kernels.uot_batched import _DTYPE_CODE

LAUNCHES = {"colsum": 0, "fused_iteration": 0}
PLAIN_CALLS = {"colsum": 0, "fused_iteration": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _check_problem(A: torch.Tensor, name: str = "A") -> None:
    if A.dim() != 2:
        raise ValueError(f"{name} must be (M, N), got {tuple(A.shape)}")
    if A.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} must be float32 or bfloat16, got "
                        f"{A.dtype}")


# ---- kernel a: column sums ---------------------------------------------------

def colsum_plain(A: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (N,) fp32 column sums."""
    PLAIN_CALLS["colsum"] += 1
    return A.float().sum(dim=0)


def colsum(A: torch.Tensor) -> torch.Tensor:
    """Initial column sums of one problem: (M, N) -> (N,) fp32."""
    _check_problem(A)
    if ub._route(A) == "plain":
        return colsum_plain(A)
    ub._check_cuda(A)
    from repro_torch.kernels import _build
    lib = _build.load()
    M, N = A.shape
    out = torch.empty(N, dtype=torch.float32, device=A.device)
    if M * N == 0:
        return out.zero_()
    plan = ub.plan_colsum(1, M, N, A.element_size())
    partial = torch.empty((plan.ctas, N), dtype=torch.float32,
                          device=A.device)
    code = lib.uot_fused_colsum(
        A.data_ptr(), partial.data_ptr(), out.data_ptr(), M, N,
        _DTYPE_CODE[A.dtype], ub._vec_for(plan, A, partial),
        plan.rows_per_cta, plan.ctas, ub._stream())
    LAUNCHES["colsum"] += 1
    _build.check(code, "colsum")
    return out


# ---- kernel b: one Algorithm-1 pass ------------------------------------------

def fused_iteration_plain(A, factor_col, a, *, fi: float):
    """Plain version of kernel b: updates ``A`` in place, returns
    ``(A, colsum)`` with colsum (N,) fp32 summed from the fp32 values
    before the storage downcast."""
    PLAIN_CALLS["fused_iteration"] += 1
    blk, _ = ub._fused_math(A[None], factor_col[None], a[None], fi)
    A.copy_(blk[0])
    return A, blk[0].sum(dim=0)


def fused_iteration(A: torch.Tensor, factor_col: torch.Tensor,
                    a: torch.Tensor, *, fi: float):
    """One MAP-UOT iteration on one problem, **in place** on ``A``.

    A: (M, N) fp32 or bf16; factor_col: (N,) fp32; a: (M,) fp32. Returns
    ``(A, next_colsum)`` with next_colsum (N,) fp32.
    """
    _check_problem(A)
    M, N = A.shape
    ub._check_vec(factor_col, (N,), "factor_col")
    ub._check_vec(a, (M,), "a")
    if ub._route(A) == "plain":
        return fused_iteration_plain(A, factor_col, a, fi=fi)
    ub._check_cuda(A, factor_col, a)
    out = torch.empty(N, dtype=torch.float32, device=A.device)
    if M * N == 0:
        return A, out.zero_()
    from repro_torch.kernels import _build
    lib = _build.load()
    plan = ub.plan_for(1, M, N, A.element_size())
    partial = torch.empty((plan.ctas, N), dtype=torch.float32,
                          device=A.device)
    code = lib.uot_fused_iteration(
        A.data_ptr(), factor_col.data_ptr(), a.data_ptr(), out.data_ptr(),
        partial.data_ptr(), M, N, _DTYPE_CODE[A.dtype],
        ub._vec_for(plan, A, factor_col, partial), plan.block_m,
        plan.rows_per_cta, plan.ctas, int(plan.one_pass), float(fi),
        int(fi == 1.0), ub._stream())
    LAUNCHES["fused_iteration"] += 1
    _build.check(code, "fused_iteration")
    return A, out
