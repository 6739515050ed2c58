"""The u/v potential form's single-problem kernels l and m: CUDA wrappers
and plain versions.

The port of ``repro.kernels.uot_uv_fused``'s ``uv_iteration`` (kernel l)
and ``materialize_coupling`` (kernel m), behind ``ops.solve_uv``. Each
wrapper takes the plain PyTorch version beside it for tensors on the CPU,
launches the hand-written CUDA kernel (``csrc/uot_uv_fused.cu``, built at
first use) for tensors on the card, and raises for anything else.

In the POT u/v form the Gibbs kernel K never changes, and an iteration
needs ``K v`` and ``K^T u``: while a block streams its rows to take
``(K v)_i``, ``u_i = (a_i / (K v)_i) ** fi`` is at hand, so ``u_i K[i, :]``
is added to the column partials in the same read. An iteration reads K
once and writes nothing (MAP-UOT's pass reads and writes the coupling).

What differs from the TPU kernels (notes in the CUDA source):

* no padding: the kernels mask ragged M and N edges, and u, v come back
  at (M,) and (N,);
* the TPU kernel carries ``K^T u`` in one accumulator that sequential grid
  steps revisit; here each block writes partial column sums that a second
  launch in the same wrapper call adds in a fixed order, so a launch gives
  the same bits on every run. l and m are kernels n and o of
  ``uot_batched`` at B=1 (``csrc/uot_stream.cuh``), l on kernel b's plan
  (``uot_batched.plan_for`` at B=1).

``LAUNCHES`` counts kernel launches per wrapper (one per wrapper call on
the card) and ``PLAIN_CALLS`` plain-version calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import uot_batched as ub
from repro_torch.kernels.uot_fused import _check_problem

LAUNCHES = {"uv_iteration": 0, "materialize_coupling": 0}
PLAIN_CALLS = {"uv_iteration": 0, "materialize_coupling": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---- kernel l: one read-only u/v pass ----------------------------------------

def uv_iteration_plain(K, v, a, *, fi: float):
    """Plain version of kernel l: ``(u, ktu)``, (M,) and (N,) fp32."""
    PLAIN_CALLS["uv_iteration"] += 1
    u, ktu = ub._uv_math(K[None], v[None], a[None], fi)
    return u[0], ktu[0]


def uv_iteration(K: torch.Tensor, v: torch.Tensor, a: torch.Tensor, *,
                 fi: float):
    """One u/v iteration's matrix work in a single read of K.

    K: (M, N) fp32 or bf16, never written; v: (N,) fp32; a: (M,) fp32.
    Returns ``(u, ktu)`` with u = safe_pow(a, K v, fi) (M,) and ktu = K^T u
    (N,), fp32; the caller finishes with v' = (b / ktu) ** fi.
    """
    _check_problem(K, "K")
    M, N = K.shape
    ub._check_vec(v, (N,), "v")
    ub._check_vec(a, (M,), "a")
    if ub._route(K) == "plain":
        return uv_iteration_plain(K, v, a, fi=fi)
    ub._check_cuda(K, v, a)
    u = torch.empty(M, dtype=torch.float32, device=K.device)
    ktu = torch.empty(N, dtype=torch.float32, device=K.device)
    if M * N == 0:
        return u.fill_(1.0), ktu.zero_()     # K v = 0 maps to factor 1
    ub._launch_uv(K, v, a, u, ktu, fi, LAUNCHES, "uv_iteration")
    return u, ktu


# ---- kernel m: the coupling -------------------------------------------------

def materialize_coupling_plain(K, u, v, *, out_dtype=torch.float32):
    """Plain version of kernel m: (M, N) in ``out_dtype``."""
    PLAIN_CALLS["materialize_coupling"] += 1
    return ub._materialize_math(K[None], u[None], v[None], out_dtype)[0]


def materialize_coupling(K: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         *, out_dtype: torch.dtype = torch.float32):
    """P = diag(u) K diag(v), one pass after the solve.

    K: (M, N) fp32 or bf16; u: (M,), v: (N,) fp32. Returns P (M, N) in
    ``out_dtype`` (fp32 or bf16), each entry ``(K * u) * v`` rounded as
    the plain version rounds it.
    """
    _check_problem(K, "K")
    ub._check_out_dtype(out_dtype)
    M, N = K.shape
    ub._check_vec(u, (M,), "u")
    ub._check_vec(v, (N,), "v")
    if ub._route(K) == "plain":
        return materialize_coupling_plain(K, u, v, out_dtype=out_dtype)
    ub._check_cuda(K, u, v)
    P = torch.empty((M, N), dtype=out_dtype, device=K.device)
    if M * N:
        ub._launch_materialize(K, u, v, P, LAUNCHES, "materialize_coupling")
    return P
