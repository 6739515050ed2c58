"""Batched kernels c, d, e, n and o: CUDA wrappers and plain versions.

The port of ``repro.kernels.uot_batched``'s ``batched_colsum``,
``batched_fused_iteration`` and ``batched_fused_iteration_frow`` (MAP-UOT's
Algorithm 1), and ``batched_uv_iteration`` and
``batched_materialize_coupling`` (the u/v potential form). Each
wrapper takes the plain PyTorch version beside it for tensors on the CPU,
launches the hand-written CUDA kernel (``csrc/uot_batched.cu``, built at
first use) for tensors on the card, and raises for anything else. There is
no fallback from the card to the plain version.

Differences from the TPU kernels, all documented in the CUDA source:

* the kernels update the coupling **in place** (the fused passes write
  ``A'`` over ``A``), which saves a second M*N buffer per pool;
* shapes need no padding: the kernels mask ragged M and N edges;
* column sums are per-block partials reduced in a fixed order, so a
  launch gives the same bits on every run;
* kernel e skips frozen lanes entirely: their tile, carried column sums
  (updated in place only for live lanes) and ``frow`` rows are untouched;
* kernel n is kernel d's pass in a read-only mode, on d's launch plan:
  the row sums of ``K * v`` give ``u``, the column partials sum the
  unscaled ``K * u``, and nothing is stored but ``u`` and ``K^T u``.

``LAUNCHES`` counts kernel launches per wrapper (one per wrapper call on
the card; the column-sum reduction rides in the same call) and
``PLAIN_CALLS`` counts plain-version calls, so a run can show which path
it took.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.problem import rescale_factors

LAUNCHES = {"batched_colsum": 0, "batched_fused_iteration": 0,
            "batched_fused_iteration_frow": 0, "batched_uv_iteration": 0,
            "batched_materialize_coupling": 0}
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)

# Hopper (H100 SXM) facts the launch plan is built from
NUM_SMS = 132
SMEM_LIMIT = 232_448          # bytes of shared memory one block may use
SM_SMEM = 233_472             # bytes of shared memory of one SM
BLOCK_SMEM_RESERVED = 1_024   # bytes the runtime keeps per resident block
MAX_BLOCKS_PER_SM = 4         # registers allow few more blocks of 256
TILE_BUDGET = 64 * 1024       # staged tile per block: 2-3 blocks per SM
MIN_ONE_PASS_ROWS = 4         # fewer staged rows than this: go two-pass
MAX_BLOCK_M = 16
THREADS = 256
# kernels a and c aim at this many blocks per SM: at 4096x4096, reading
# device memory, two (rows of 63 fp32 / 32 bf16 per block) ran at 2.24 /
# 1.86 TB/s, four at 2.33 / 1.71 TB/s (scripts/sweep_stream_plans.py)
COLSUM_BLOCKS_PER_SM = 2
COLSUM_MIN_ROWS = 8

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch cuts a (B, M, N) stack: ``block_m`` rows per
    sub-block, ``rows_per_cta`` rows per block (``ctas`` blocks per
    problem, ``R`` in the source), whether sub-blocks are staged in shared
    memory (``one_pass``), the vector width in elements, and the shared
    memory the fused kernel asks for."""

    one_pass: bool
    block_m: int
    rows_per_cta: int
    ctas: int
    vec: int
    smem_bytes: int

    @property
    def variant(self) -> str:
        return "one-pass" if self.one_pass else "two-pass"

    def partial_bytes(self, B: int, N: int) -> int:
        return 4 * B * self.ctas * N


def _pow2_floor(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def pick_block_m(M: int, N: int, itemsize: int = 4) -> int:
    """Rows per sub-block for Hopper: the largest power of two (at most
    ``MAX_BLOCK_M``, and no more than the problem needs) whose storage
    tile ``bm * N * itemsize`` fits ``TILE_BUDGET`` of shared memory; 1
    when even one row does not fit (the two-pass variant then re-reads one
    row at a time from L2)."""
    bm = _pow2_floor(max(1, TILE_BUDGET // max(1, N * itemsize)))
    bm = min(bm, MAX_BLOCK_M, _pow2_floor(max(1, M)) * 2)
    return max(1, bm)


def _fused_smem(N: int, bm: int, itemsize: int, one_pass: bool) -> int:
    wpr = 1 if bm >= THREADS // 32 else (THREADS // 32) // bm
    head = ((N + bm * wpr + bm) * 4 + 15) // 16 * 16
    return head + (bm * N * itemsize if one_pass else 0)


def plan_for(B: int, M: int, N: int, itemsize: int, *,
             num_sms: int = NUM_SMS) -> Plan:
    """The launch plan for a (B, M, N) stack of ``itemsize``-byte storage.

    One-pass when ``MIN_ONE_PASS_ROWS`` rows of the tile fit the budget.
    Blocks take whole sub-blocks, and the grid is one wave: as many blocks
    as the shared memory each one asks for lets the SMs hold at once (at
    most ``MAX_BLOCKS_PER_SM`` each), with as few rows per block as that
    allows; a problem gets at least one block. A grid a little over one
    wave leaves a tail of blocks running on a nearly idle card: at
    4096x4096 fp32, 342 blocks took 0.0945 ms and 256 took 0.0735 ms
    (``scripts/sweep_stream_plans.py``). Raises for rows too wide for one
    block's column accumulator.
    """
    bm = pick_block_m(M, N, itemsize)
    one_pass = bm * N * itemsize <= TILE_BUDGET and bm >= min(
        MIN_ONE_PASS_ROWS, _pow2_floor(max(1, M)))
    smem = _fused_smem(N, bm, itemsize, one_pass)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"N={N} is too wide for the batched kernels (a block's column "
            f"accumulator needs {smem} bytes of shared memory, limit "
            f"{SMEM_LIMIT}); the wide-N half-pass kernels are a later slice")
    per_sm = SM_SMEM // (smem + BLOCK_SMEM_RESERVED)
    per_problem = max(1, num_sms * min(MAX_BLOCKS_PER_SM, per_sm) // B)
    rows = -(-M // per_problem)
    rows = -(-rows // bm) * bm
    ctas = -(-M // rows)
    vec = 16 // itemsize if N % (16 // itemsize) == 0 else 1
    return Plan(one_pass=one_pass, block_m=bm, rows_per_cta=rows, ctas=ctas,
                vec=vec, smem_bytes=smem)


def plan_colsum(B: int, M: int, N: int, itemsize: int, *,
                num_sms: int = NUM_SMS) -> Plan:
    """Launch plan of kernels c and a (a is c at B=1): a grid of (row
    blocks, column tiles, problems), each column tile ``THREADS`` vectors
    wide, with as many row blocks per problem as bring the grid to about
    ``COLSUM_BLOCKS_PER_SM`` blocks per SM, and at least
    ``COLSUM_MIN_ROWS`` rows per block so the partial sums stay a small
    share of the bytes. The kernel uses no shared memory."""
    vec = 16 // itemsize if N % (16 // itemsize) == 0 else 1
    tiles = -(-(N // vec) // THREADS)
    per_problem = max(1, -(-COLSUM_BLOCKS_PER_SM * num_sms // (tiles * B)))
    rows = max(min(COLSUM_MIN_ROWS, M), -(-M // per_problem), 1)
    return Plan(one_pass=True, block_m=rows, rows_per_cta=rows,
                ctas=-(-M // rows), vec=vec, smem_bytes=0)


# ---- argument checks ---------------------------------------------------------

def _check_stack(A: torch.Tensor, name: str = "A") -> None:
    if A.dim() != 3:
        raise ValueError(f"{name} must be (B, M, N), got {tuple(A.shape)}")
    if A.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} must be float32 or bfloat16, got {A.dtype}")


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"vs {dev}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def _check_vec(t: torch.Tensor, shape, name: str,
               dtype: torch.dtype = torch.float32) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _route(A: torch.Tensor) -> str:
    if A.device.type == "cpu":
        return "plain"
    if A.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for tensors on {A.device}")


def _vec_for(plan: Plan, *tensors: torch.Tensor) -> int:
    if plan.vec > 1 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return plan.vec
    return 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---- kernel c: per-problem column sums ---------------------------------------

def batched_colsum_plain(A: torch.Tensor) -> torch.Tensor:
    """(B, M, N) -> (B, N) fp32 column sums."""
    PLAIN_CALLS["batched_colsum"] += 1
    return A.float().sum(dim=1)


def batched_colsum(A: torch.Tensor) -> torch.Tensor:
    """Per-problem initial column sums: (B, M, N) -> (B, N) fp32."""
    _check_stack(A)
    if _route(A) == "plain":
        return batched_colsum_plain(A)
    _check_cuda(A)
    from repro_torch.kernels import _build
    lib = _build.load()
    B, M, N = A.shape
    out = torch.empty((B, N), dtype=torch.float32, device=A.device)
    if B * M * N == 0:
        return out.zero_()
    plan = plan_colsum(B, M, N, A.element_size())
    partial = torch.empty((B, plan.ctas, N), dtype=torch.float32,
                          device=A.device)
    code = lib.uot_batched_colsum(
        A.data_ptr(), partial.data_ptr(), out.data_ptr(), B, M, N,
        _DTYPE_CODE[A.dtype], _vec_for(plan, A, partial), plan.rows_per_cta,
        plan.ctas, _stream())
    LAUNCHES["batched_colsum"] += 1
    _build.check(code, "batched_colsum")
    return out


# ---- kernels d and e: one Algorithm-1 pass -----------------------------------

def _fused_math(A, factor_col, a, fi):
    blk = A.float() * factor_col.float()[:, None, :]   # I: column rescale
    rowsum = blk.sum(dim=2)                            # II
    frow = rescale_factors(a.float(), rowsum, fi)
    blk = blk * frow[:, :, None]                       # III: row rescale
    return blk, frow


def batched_fused_iteration_plain(A, factor_col, a, *, fi: float):
    """Plain version of kernel d: updates ``A`` in place, returns
    ``(A, colsum)`` with colsum (B, N) fp32 summed from the fp32 values
    before the storage downcast."""
    PLAIN_CALLS["batched_fused_iteration"] += 1
    blk, _ = _fused_math(A, factor_col, a, fi)
    A.copy_(blk)
    return A, blk.sum(dim=1)


def batched_fused_iteration(A: torch.Tensor, factor_col: torch.Tensor,
                            a: torch.Tensor, *, fi: float):
    """One MAP-UOT iteration for a stack, **in place** on ``A``.

    A: (B, M, N) fp32 or bf16; factor_col: (B, N) fp32; a: (B, M) fp32.
    Returns ``(A, next_colsum)`` with next_colsum (B, N) fp32.
    """
    _check_stack(A)
    B, M, N = A.shape
    _check_vec(factor_col, (B, N), "factor_col")
    _check_vec(a, (B, M), "a")
    if _route(A) == "plain":
        return batched_fused_iteration_plain(A, factor_col, a, fi=fi)
    colsum = torch.empty((B, N), dtype=torch.float32, device=A.device)
    _launch_fused(A, factor_col, a, None, colsum, None, fi,
                  "batched_fused_iteration")
    return A, colsum


def batched_fused_iteration_frow_plain(A, factor_col, a, mask, colsum, *,
                                       fi: float):
    """Plain version of kernel e: for lanes with ``mask`` set, updates
    ``A`` and ``colsum`` in place; returns ``(A, colsum, frow)`` with the
    computed frow of every lane (the kernel leaves frozen lanes' rows
    unwritten — callers mask them)."""
    PLAIN_CALLS["batched_fused_iteration_frow"] += 1
    blk, frow = _fused_math(A, factor_col, a, fi)
    m = mask.to(torch.bool)
    A[m] = blk[m].to(A.dtype)
    colsum[m] = blk[m].sum(dim=1)
    return A, colsum, frow


def batched_fused_iteration_frow(A: torch.Tensor, factor_col: torch.Tensor,
                                 a: torch.Tensor, mask: torch.Tensor,
                                 colsum: torch.Tensor, *, fi: float):
    """One masked batched MAP-UOT iteration that also emits row factors.

    The stepped-pool form of ``batched_fused_iteration``. ``mask`` (B,)
    bool (True = update) selects the live lanes; ``colsum`` (B, N) fp32 is
    the carried column-sum buffer. Live lanes get ``A`` and ``colsum``
    updated **in place**; a frozen lane's tile and carried column sums are
    not touched, so they stay bit-for-bit what they were (the reference's
    carried-colsum re-select, ``ops.py:630``, for free). Returns
    ``(A, colsum, frow)``: frow (B, M) fp32 holds this iteration's row
    factors for live lanes; frozen lanes' rows are unspecified.
    """
    _check_stack(A)
    B, M, N = A.shape
    _check_vec(factor_col, (B, N), "factor_col")
    _check_vec(a, (B, M), "a")
    _check_vec(mask, (B,), "mask", torch.bool)
    _check_vec(colsum, (B, N), "colsum")
    if _route(A) == "plain":
        return batched_fused_iteration_frow_plain(A, factor_col, a, mask,
                                                  colsum, fi=fi)
    frow = torch.empty((B, M), dtype=torch.float32, device=A.device)
    _launch_fused(A, factor_col, a, mask, colsum, frow, fi,
                  "batched_fused_iteration_frow")
    return A, colsum, frow


def _launch_fused(A, fcol, a, mask, colsum, frow, fi, name):
    ops = [A, fcol, a, colsum] + ([mask, frow] if mask is not None else [])
    _check_cuda(*ops)
    B, M, N = A.shape
    if B * M * N == 0:
        if mask is None:
            colsum.zero_()
        return
    from repro_torch.kernels import _build
    lib = _build.load()
    plan = plan_for(B, M, N, A.element_size())
    partial = torch.empty((B, plan.ctas, N), dtype=torch.float32,
                          device=A.device)
    mask_ptr = mask.data_ptr() if mask is not None else None
    frow_ptr = frow.data_ptr() if frow is not None else None
    code = lib.uot_batched_fused_iteration(
        A.data_ptr(), fcol.data_ptr(), a.data_ptr(), mask_ptr,
        colsum.data_ptr(), frow_ptr, partial.data_ptr(), B, M, N,
        _DTYPE_CODE[A.dtype], _vec_for(plan, A, fcol, partial),
        plan.block_m, plan.rows_per_cta, plan.ctas, int(plan.one_pass),
        float(fi), int(fi == 1.0), _stream())
    LAUNCHES[name] += 1
    _build.check(code, name)


# ---- kernels n and o: the u/v potential form ---------------------------------

def _uv_math(K, v, a, fi):
    """u = safe_pow(a, K v, fi) and K^T u over a stack, in fp32, as the
    reference's kernel body computes them (uot_batched.py:210-225)."""
    Kf = K.float()
    u = rescale_factors(a, (Kf * v[:, None, :]).sum(dim=2), fi)
    return u, (Kf * u[:, :, None]).sum(dim=1)


def _materialize_math(K, u, v, out_dtype):
    """(K * u[:, None]) * v[None, :] per problem: two fp32 products in the
    reference's order, rounded once to ``out_dtype``."""
    return ((K.float() * u[:, :, None]) * v[:, None, :]).to(out_dtype)


def batched_uv_iteration_plain(K, v, a, *, fi: float):
    """Plain version of kernel n: ``(u, ktu)``, (B, M) and (B, N) fp32."""
    PLAIN_CALLS["batched_uv_iteration"] += 1
    return _uv_math(K, v, a, fi)


def batched_uv_iteration(K: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
                         *, fi: float):
    """One u/v iteration's matrix work for a stack, in a single read of K.

    K: (B, M, N) fp32 or bf16, never written; v: (B, N) fp32; a: (B, M)
    fp32. Returns ``(u, ktu)`` with u = safe_pow(a, K v, fi) (B, M) and
    ktu = K^T u (B, N), fp32; the caller finishes with v' = (b / ktu) ** fi.
    """
    _check_stack(K, "K")
    B, M, N = K.shape
    _check_vec(v, (B, N), "v")
    _check_vec(a, (B, M), "a")
    if _route(K) == "plain":
        return batched_uv_iteration_plain(K, v, a, fi=fi)
    _check_cuda(K, v, a)
    u = torch.empty((B, M), dtype=torch.float32, device=K.device)
    ktu = torch.empty((B, N), dtype=torch.float32, device=K.device)
    if B * M * N == 0:
        return u.fill_(1.0), ktu.zero_()     # K v = 0 maps to factor 1
    _launch_uv(K, v, a, u, ktu, fi, LAUNCHES, "batched_uv_iteration")
    return u, ktu


def _launch_uv(K, v, a, u, ktu, fi, counts, name):
    """Launch the u/v pass on kernel d's plan: kernel n for a (B, M, N)
    stack, kernel l for one (M, N) problem (``counts[name]`` counts it)."""
    from repro_torch.kernels import _build
    lib = _build.load()
    M, N = K.shape[-2:]
    B = K.shape[0] if K.dim() == 3 else 1
    plan = plan_for(B, M, N, K.element_size())
    partial = torch.empty((B, plan.ctas, N), dtype=torch.float32,
                          device=K.device)
    ptrs = (K.data_ptr(), v.data_ptr(), a.data_ptr(), u.data_ptr(),
            ktu.data_ptr(), partial.data_ptr())
    rest = (M, N, _DTYPE_CODE[K.dtype], _vec_for(plan, K, v, partial),
            plan.block_m, plan.rows_per_cta, plan.ctas, int(plan.one_pass),
            float(fi), int(fi == 1.0), _stream())
    if K.dim() == 3:
        code = lib.uot_batched_uv_iteration(*ptrs, B, *rest)
    else:
        code = lib.uot_uv_iteration(*ptrs, *rest)
    counts[name] += 1
    _build.check(code, name)


def _check_out_dtype(out_dtype) -> None:
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")


def batched_materialize_coupling_plain(K, u, v, *,
                                       out_dtype=torch.float32):
    """Plain version of kernel o: (B, M, N) in ``out_dtype``."""
    PLAIN_CALLS["batched_materialize_coupling"] += 1
    return _materialize_math(K, u, v, out_dtype)


def batched_materialize_coupling(K: torch.Tensor, u: torch.Tensor,
                                 v: torch.Tensor, *,
                                 out_dtype: torch.dtype = torch.float32):
    """P_b = diag(u_b) K_b diag(v_b) for every problem of the stack.

    K: (B, M, N) fp32 or bf16; u: (B, M), v: (B, N) fp32. Returns P
    (B, M, N) in ``out_dtype`` (fp32 or bf16), each entry
    ``(K * u) * v`` rounded as the plain version rounds it.
    """
    _check_stack(K, "K")
    _check_out_dtype(out_dtype)
    B, M, N = K.shape
    _check_vec(u, (B, M), "u")
    _check_vec(v, (B, N), "v")
    if _route(K) == "plain":
        return batched_materialize_coupling_plain(K, u, v,
                                                  out_dtype=out_dtype)
    _check_cuda(K, u, v)
    P = torch.empty((B, M, N), dtype=out_dtype, device=K.device)
    if B * M * N:
        _launch_materialize(K, u, v, P, LAUNCHES,
                            "batched_materialize_coupling")
    return P


def _launch_materialize(K, u, v, P, counts, name):
    """Launch kernel o for a (B, M, N) stack, kernel m for one (M, N)
    problem (``counts[name]`` counts it)."""
    from repro_torch.kernels import _build
    lib = _build.load()
    M, N = K.shape[-2:]
    width = 16 // K.element_size()
    vec = width if N % width == 0 and all(
        t.data_ptr() % 16 == 0 for t in (K, v, P)) else 1
    args = (M, N, _DTYPE_CODE[K.dtype], _DTYPE_CODE[P.dtype], vec, NUM_SMS,
            _stream())
    ptrs = (K.data_ptr(), u.data_ptr(), v.data_ptr(), P.data_ptr())
    if K.dim() == 3:
        code = lib.uot_batched_materialize_coupling(*ptrs, K.shape[0], *args)
    else:
        code = lib.uot_materialize_coupling(*ptrs, *args)
    counts[name] += 1
    _build.check(code, name)
