"""Point-cloud geometry kernels h, i and j: CUDA wrappers and plain versions.

The port of ``repro.kernels.uot_geometry``'s ``batched_pc_colsum`` (kernel
h), ``batched_pc_first_iteration`` (kernel i) and
``batched_pc_materialize`` (kernel j). Each computes the masked Gibbs tile
``exp(-||x - y||^2 / (scale * reg))`` of a point-cloud stack from its
coordinates instead of reading an M*N matrix (``csrc/uot_gibbs.cuh``): h
takes the initial column sums with nothing M*N-sized read or written, i
runs iteration 1 and writes the rescaled ``A1`` (so ``K`` never reaches
device memory), j stores the masked stack. Each wrapper takes the plain
PyTorch version beside it for tensors on the CPU, launches the CUDA kernel
(``csrc/uot_geometry.cu``, built at first use) for tensors on the card,
and raises for anything else. There is no fallback from the card to the
plain version.

Operands (no alignment padding; the kernels mask ragged edges):
x (B, M, d), xn (B, M), y (B, N, d), yn (B, N) fp32; m_valid, n_valid (B,)
int32 per-problem valid counts: entries at or past them are exactly 0.0.

In-port contracts. h and i are kernels c and d with the tile computed
(the same plan and summation order), so on the card h's sums equal c's
over j's output and i's pass equals d's, bit for bit; the plain versions
are the dense plain versions over the plain tile, so the CPU paths agree
bit for bit too. The tile's storage round trip (``storage_dtype`` /
``out_dtype`` bf16) gives the values a bf16 copy of the fp32 kernel holds.

``LAUNCHES`` counts kernel launches per wrapper (one per call on the card)
and ``PLAIN_CALLS`` plain-version calls.
"""
from __future__ import annotations

import torch

from repro_torch.geometry.pointcloud import gibbs_tile, valid_mask
from repro_torch.kernels import uot_batched as ub
from repro_torch.kernels.uot_batched import _DTYPE_CODE

LAUNCHES = {"batched_pc_colsum": 0, "batched_pc_first_iteration": 0,
            "batched_pc_materialize": 0}
PLAIN_CALLS = {"batched_pc_colsum": 0, "batched_pc_first_iteration": 0,
               "batched_pc_materialize": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _check_coords(x, xn, y, yn, m_valid, n_valid):
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != y.shape[2]:
        raise ValueError(f"x must be (B, M, d) and y (B, N, d), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    B, M, d = x.shape
    N = y.shape[1]
    if d < 1:
        raise ValueError("coordinates need d >= 1")
    for t, shape, name in ((x, (B, M, d), "x"), (y, (B, N, d), "y")):
        ub._check_vec(t, shape, name)
    ub._check_vec(xn, (B, M), "xn")
    ub._check_vec(yn, (B, N), "yn")
    ub._check_vec(m_valid, (B,), "m_valid", torch.int32)
    ub._check_vec(n_valid, (B,), "n_valid", torch.int32)
    return B, M, N, d


def _gibbs_stack(x, xn, y, yn, m_valid, n_valid, *, reg, scale, dtype):
    """The masked Gibbs stack in fp32, rounded through ``dtype`` (the tile
    every plain version starts from)."""
    B, M, _ = x.shape
    N = y.shape[1]
    K = gibbs_tile(x, xn[:, :, None], y, yn[:, None, :], reg=float(reg),
                   scale=float(scale))
    K = torch.where(valid_mask(M, N, m_valid, n_valid, device=K.device), K,
                    torch.zeros((), dtype=K.dtype, device=K.device))
    return K.to(dtype)


def _gibbs_ptrs(x, xn, y, yn, m_valid, n_valid, reg, scale):
    """The coordinate operands as the launchers take them: y transposed to
    (B, d, N) for coalesced reads (kept alive by the returned tuple's
    first element), then reg, scale and whether to divide by it."""
    yt = y.transpose(1, 2).contiguous()
    ptrs = (x.data_ptr(), xn.data_ptr(), yt.data_ptr(), yn.data_ptr(),
            m_valid.data_ptr(), n_valid.data_ptr())
    return yt, ptrs, (float(reg), float(scale), int(float(scale) != 1.0))


def _on_card(*tensors):
    ub._check_cuda(*tensors)
    from repro_torch.kernels import _build
    return _build, _build.load()


# ---- kernel j: the masked Gibbs stack ------------------------------------------

def batched_pc_materialize_plain(x, xn, y, yn, m_valid, n_valid, *,
                                 reg: float, scale: float = 1.0,
                                 out_dtype=torch.float32):
    """Plain version of kernel j: (B, M, N) in ``out_dtype``."""
    PLAIN_CALLS["batched_pc_materialize"] += 1
    return _gibbs_stack(x, xn, y, yn, m_valid, n_valid, reg=reg,
                        scale=scale, dtype=out_dtype)


def batched_pc_materialize(x, xn, y, yn, m_valid, n_valid, *, reg: float,
                           scale: float = 1.0, out_dtype=torch.float32):
    """The masked Gibbs stack from coordinates: (B, M, N) in ``out_dtype``
    (fp32 or bf16), exactly 0.0 past each problem's valid counts."""
    B, M, N, d = _check_coords(x, xn, y, yn, m_valid, n_valid)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if ub._route(x) == "plain":
        return batched_pc_materialize_plain(x, xn, y, yn, m_valid, n_valid,
                                            reg=reg, scale=scale,
                                            out_dtype=out_dtype)
    build, lib = _on_card(x, xn, y, yn, m_valid, n_valid)
    out = torch.empty((B, M, N), dtype=out_dtype, device=x.device)
    if B * M * N == 0:
        return out
    yt, ptrs, consts = _gibbs_ptrs(x, xn, y, yn, m_valid, n_valid, reg,
                                   scale)
    vec = 16 // out.element_size()
    vec = vec if N % vec == 0 and out.data_ptr() % 16 == 0 else 1
    code = lib.uot_pc_materialize(out.data_ptr(), *ptrs, B, M, N, d,
                                  _DTYPE_CODE[out_dtype], vec, *consts,
                                  ub._stream())
    LAUNCHES["batched_pc_materialize"] += 1
    build.check(code, "batched_pc_materialize")
    return out


# ---- kernel h: initial column sums ---------------------------------------------

def batched_pc_colsum_plain(x, xn, y, yn, m_valid, n_valid, *, reg: float,
                            scale: float = 1.0,
                            storage_dtype=torch.float32):
    """Plain version of kernel h: (B, N) fp32 column sums of the tile
    rounded through ``storage_dtype``."""
    PLAIN_CALLS["batched_pc_colsum"] += 1
    return _gibbs_stack(x, xn, y, yn, m_valid, n_valid, reg=reg, scale=scale,
                        dtype=storage_dtype).float().sum(dim=1)


def batched_pc_colsum(x, xn, y, yn, m_valid, n_valid, *, reg: float,
                      scale: float = 1.0, storage_dtype=torch.float32):
    """Initial column sums straight from coordinates: (B, N) fp32.

    ``storage_dtype`` is the dtype the dense path would store ``A0`` in;
    the computed tile takes the same rounding, so the sums are kernel c's
    over that stored stack.
    """
    B, M, N, d = _check_coords(x, xn, y, yn, m_valid, n_valid)
    if storage_dtype not in _DTYPE_CODE:
        raise TypeError(f"storage_dtype must be float32 or bfloat16, got "
                        f"{storage_dtype}")
    if ub._route(x) == "plain":
        return batched_pc_colsum_plain(x, xn, y, yn, m_valid, n_valid,
                                       reg=reg, scale=scale,
                                       storage_dtype=storage_dtype)
    build, lib = _on_card(x, xn, y, yn, m_valid, n_valid)
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B * M * N == 0:
        return out.zero_()
    s = torch.empty((), dtype=storage_dtype).element_size()
    plan = ub.plan_colsum(B, M, N, s)
    partial = torch.empty((B, plan.ctas, N), dtype=torch.float32,
                          device=x.device)
    yt, ptrs, consts = _gibbs_ptrs(x, xn, y, yn, m_valid, n_valid, reg,
                                   scale)
    code = lib.uot_pc_colsum(*ptrs, partial.data_ptr(), out.data_ptr(), B, M,
                             N, d, _DTYPE_CODE[storage_dtype],
                             ub._vec_for(plan, partial), plan.rows_per_cta,
                             plan.ctas, *consts, ub._stream())
    LAUNCHES["batched_pc_colsum"] += 1
    build.check(code, "batched_pc_colsum")
    return out


# ---- kernel i: iteration 1 with the tile computed ------------------------------

def batched_pc_first_iteration_plain(factor_col, a, x, xn, y, yn, m_valid,
                                     n_valid, *, fi: float, reg: float,
                                     scale: float = 1.0,
                                     out_dtype=torch.float32):
    """Plain version of kernel i: kernel d's plain pass over the tile."""
    PLAIN_CALLS["batched_pc_first_iteration"] += 1
    K = _gibbs_stack(x, xn, y, yn, m_valid, n_valid, reg=reg, scale=scale,
                     dtype=out_dtype)
    blk, frow = ub._fused_math(K, factor_col, a, fi)
    return blk.to(out_dtype), blk.sum(dim=1), frow


def batched_pc_first_iteration(factor_col, a, x, xn, y, yn, m_valid,
                               n_valid, *, fi: float, reg: float,
                               scale: float = 1.0, out_dtype=torch.float32):
    """Iteration 1 of Algorithm 1 with the input tile computed.

    factor_col: (B, N) fp32 column factors from kernel h's sums; a: (B, M)
    fp32 row marginals; the coordinates as for ``batched_pc_colsum``.
    Returns ``(A1, next_colsum, frow)``: (B, M, N) in ``out_dtype`` (the
    solve's storage dtype), (B, N) and (B, M) fp32. From here the streamed
    kernels d / e iterate on ``A1``.
    """
    B, M, N, d = _check_coords(x, xn, y, yn, m_valid, n_valid)
    ub._check_vec(factor_col, (B, N), "factor_col")
    ub._check_vec(a, (B, M), "a")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if ub._route(x) == "plain":
        return batched_pc_first_iteration_plain(
            factor_col, a, x, xn, y, yn, m_valid, n_valid, fi=fi, reg=reg,
            scale=scale, out_dtype=out_dtype)
    build, lib = _on_card(factor_col, a, x, xn, y, yn, m_valid, n_valid)
    dev = x.device
    A = torch.empty((B, M, N), dtype=out_dtype, device=dev)
    colsum = torch.empty((B, N), dtype=torch.float32, device=dev)
    frow = torch.empty((B, M), dtype=torch.float32, device=dev)
    if B * M * N == 0:
        return A, colsum.zero_(), frow.fill_(1.0)
    plan = ub.plan_for(B, M, N, A.element_size())
    partial = torch.empty((B, plan.ctas, N), dtype=torch.float32, device=dev)
    yt, ptrs, consts = _gibbs_ptrs(x, xn, y, yn, m_valid, n_valid, reg,
                                   scale)
    code = lib.uot_pc_first_iteration(
        A.data_ptr(), factor_col.data_ptr(), a.data_ptr(), colsum.data_ptr(),
        frow.data_ptr(), partial.data_ptr(), *ptrs, B, M, N, d,
        _DTYPE_CODE[out_dtype], ub._vec_for(plan, A, factor_col, partial),
        plan.block_m, plan.rows_per_cta, plan.ctas, int(plan.one_pass),
        float(fi), int(fi == 1.0), *consts, ub._stream())
    LAUNCHES["batched_pc_first_iteration"] += 1
    build.check(code, "batched_pc_first_iteration")
    return A, colsum, frow
