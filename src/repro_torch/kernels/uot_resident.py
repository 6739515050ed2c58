"""Resident MAP-UOT kernels f, g and k: CUDA wrappers and plain versions.

The port of ``repro.kernels.uot_resident``'s ``resident_solve`` (kernel f),
``resident_stepped`` (kernel g) and ``resident_solve_pc`` (kernel k, f with
the tile computed from point-cloud coordinates instead of loaded, so a
solve reads O((M + N) * d) floats and writes M*N once; on the same
coordinates k equals f on kernel j's output, bit for bit on the card): one
block per lane loads the lane's
coupling once into shared memory as fp32, iterates Algorithm 1 there and
stores it once, so a solve (f) or a chunk (g) moves the M*N tile through
device memory once each way instead of once per iteration. Each wrapper
takes the plain PyTorch version beside it for tensors on the CPU,
launches the hand-written CUDA kernel (``csrc/uot_resident.cu``, built at
first use) for tensors on the card, and raises for anything else. There
is no fallback from the card to the plain version.

What differs from the TPU kernels (notes in the CUDA source):

* both update their tensors **in place**: f writes the solution over the
  input stack, g advances the pool's ``P``, ``colsum``, ``frow``,
  ``iters`` and ``converged`` where they lie, and a lane whose gate is
  closed is not touched at all;
* the budget is one block's shared memory (``SMEM_LIMIT``), holding only
  the fp32 working tile and four O(M + N) vectors
  (``resident_smem_bytes``), where the TPU tier budgeted double-buffered
  in and out tiles against 32 MiB of VMEM;
* no padding: a lane holds exactly (M, N).

``resident_solve_plain`` is the port of ``resident_solve_jnp``: the whole
stack upcast once, frozen lanes held by unit factors, downcast once.
``LAUNCHES`` counts kernel launches per wrapper and ``PLAIN_CALLS``
plain-version calls.
"""
from __future__ import annotations

import torch

from repro_torch.core.problem import rescale_factors
from repro_torch.kernels import uot_batched as ub
from repro_torch.kernels.uot_batched import _DTYPE_CODE, SMEM_LIMIT

LAUNCHES = {"resident_solve": 0, "resident_stepped": 0,
            "resident_solve_pc": 0}
PLAIN_CALLS = {"resident_solve": 0, "resident_stepped": 0,
               "resident_solve_pc": 0}

RES_WARPS = 32          # 1024 threads per block; one drift slot per warp


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def resident_smem_bytes(M: int, N: int) -> int:
    """Shared memory one lane needs: the fp32 tile, colsum (reused as the
    column factors) and b, frow and a, and the drift scratch."""
    return 4 * (M * N + 2 * M + 2 * N + RES_WARPS)


def lane_fits(M: int, N: int) -> bool:
    """Whether an (M, N) lane fits one block's shared memory."""
    return resident_smem_bytes(M, N) <= SMEM_LIMIT


def _check_lanes(A: torch.Tensor, *vecs) -> None:
    ub._check_stack(A)
    B, M, N = A.shape
    for t, shape, name, dtype in vecs:
        ub._check_vec(t, shape, name, dtype)
    if not lane_fits(M, N):
        raise ValueError(
            f"({M}, {N}) does not fit the resident kernels: a lane needs "
            f"{resident_smem_bytes(M, N)} bytes of shared memory, the limit "
            f"is {SMEM_LIMIT}; use impl='auto' to stream it")


def _one_iter(X, colsum, a, b, fi, upd):
    """One Algorithm-1 iteration on an fp32 stack, out of place. Lanes with
    ``upd`` False get unit factors (exact no-ops) and keep their colsum."""
    fcol = rescale_factors(b, colsum, fi)
    if upd is not None:
        fcol = torch.where(upd[:, None], fcol, 1.0)
    X = X * fcol[:, None, :]
    frow = rescale_factors(a, X.sum(dim=2), fi)
    frow_m = frow if upd is None else torch.where(upd[:, None], frow, 1.0)
    X = X * frow_m[:, :, None]
    cs = X.sum(dim=1)
    if upd is not None:
        cs = torch.where(upd[:, None], cs, colsum)
    return X, cs, frow


# ---- kernel f: the whole solve ------------------------------------------------

def resident_solve_plain(A, a, b, *, fi: float, num_iters: int,
                         tol: float | None = None):
    """Plain version of kernel f (the port of ``resident_solve_jnp``):
    overwrites ``A`` with the solution; returns ``(A, colsum, iters,
    err)``."""
    PLAIN_CALLS["resident_solve"] += 1
    return _solve_math(A, a, b, fi=fi, num_iters=num_iters, tol=tol)


def _solve_math(A, a, b, *, fi, num_iters, tol):
    B = A.shape[0]
    X = A.to(torch.float32, copy=True)            # upcast once
    a, b = a.float(), b.float()
    colsum = X.sum(dim=1)
    prev = torch.ones_like(a)
    err = torch.full((B,), float("inf"), device=A.device)
    iters = torch.zeros(B, dtype=torch.int32, device=A.device)
    conv = torch.zeros(B, dtype=torch.bool, device=A.device)
    for _ in range(num_iters):
        if tol is None:
            X, colsum, frow = _one_iter(X, colsum, a, b, fi, None)
            err = torch.amax(torch.abs(frow - prev), dim=-1)
            prev = frow
            iters += 1
            continue
        if bool(conv.all()):
            break
        upd = ~conv
        X, colsum, frow = _one_iter(X, colsum, a, b, fi, upd)
        drift = torch.amax(torch.abs(frow - prev), dim=-1)
        err = torch.where(upd, drift, err)
        prev = torch.where(upd[:, None], frow, prev)
        iters += upd.to(torch.int32)
        conv |= upd & (drift <= tol)
    A.copy_(X)                                    # downcast once
    return A, colsum, iters, err


def resident_solve(A: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                   fi: float, num_iters: int, tol: float | None = None):
    """Whole-solve resident MAP-UOT for a stack, **in place** on ``A``.

    A: (B, M, N) fp32 or bf16; a: (B, M), b: (B, N) fp32. Each lane runs up
    to ``num_iters`` iterations with its tile in shared memory, stopping
    when its row-factor drift reaches ``tol`` (exactly ``num_iters``
    without one). Returns ``(A, colsum, iters, err)``: the solutions in the
    storage dtype, their fp32 column sums (B, N), and per-lane iteration
    counts (int32) and final drifts (fp32).
    """
    B, M, N = A.shape if A.dim() == 3 else (0, 0, 0)
    _check_lanes(A, (a, (B, M), "a", torch.float32),
                 (b, (B, N), "b", torch.float32))
    if ub._route(A) == "plain":
        return resident_solve_plain(A, a, b, fi=fi, num_iters=num_iters,
                                    tol=tol)
    ub._check_cuda(A, a, b)
    from repro_torch.kernels import _build
    lib = _build.load()
    dev = A.device
    colsum = torch.empty((B, N), dtype=torch.float32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return A, colsum, iters, err
    code = lib.uot_resident_solve(
        A.data_ptr(), a.data_ptr(), b.data_ptr(), colsum.data_ptr(),
        iters.data_ptr(), err.data_ptr(), B, M, N, _DTYPE_CODE[A.dtype],
        float(fi), int(fi == 1.0), int(num_iters),
        float(tol) if tol is not None else 0.0, int(tol is not None),
        ub._stream())
    LAUNCHES["resident_solve"] += 1
    _build.check(code, "resident_solve")
    return A, colsum, iters, err


# ---- kernel g: a chunk of a lane pool -----------------------------------------

def resident_stepped_plain(P, colsum, frow, iters, converged, active, a, b,
                           *, fi: float, n_iters: int, num_iters: int,
                           tol: float | None = None):
    """Plain version of kernel g: the same per-lane gate and loop, with
    frozen lanes held by unit factors; only lanes whose gate was open on
    entry are written back."""
    PLAIN_CALLS["resident_stepped"] += 1
    gate = active & ~converged & (iters < num_iters)
    if n_iters <= 0 or not bool(gate.any()):
        return P, colsum, frow, iters, converged
    X = P.to(torch.float32, copy=True)            # upcast once per chunk
    cs, prev = colsum.clone(), frow.clone()
    it, conv = iters.clone(), converged.clone()
    run = gate.clone()
    for _ in range(n_iters):
        run = run & ~conv & (it < num_iters)
        if not bool(run.any()):
            break
        X, cs, fr = _one_iter(X, cs, a, b, fi, run)
        drift = torch.amax(torch.abs(fr - prev), dim=-1)
        prev = torch.where(run[:, None], fr, prev)
        it += run.to(torch.int32)
        if tol is not None:
            conv |= run & (drift <= tol)
    P[gate] = X[gate].to(P.dtype)                 # downcast once per chunk
    colsum[gate] = cs[gate]
    frow[gate] = prev[gate]
    iters[gate] = it[gate]
    converged[gate] = conv[gate]
    return P, colsum, frow, iters, converged


def resident_stepped(P: torch.Tensor, colsum: torch.Tensor,
                     frow: torch.Tensor, iters: torch.Tensor,
                     converged: torch.Tensor, active: torch.Tensor,
                     a: torch.Tensor, b: torch.Tensor, *, fi: float,
                     n_iters: int, num_iters: int,
                     tol: float | None = None):
    """Advance a lane pool by up to ``n_iters`` iterations with each lane's
    tile resident in shared memory, **in place**.

    P (L, M, N) fp32 or bf16; colsum (L, N) and frow (L, M) fp32 carried
    state; iters (L,) int32; converged and active (L,) bool; a (L, M), b
    (L, N) fp32. A lane runs while it is active, not converged, below
    ``num_iters`` and below ``n_iters`` iterations of this call; with
    ``tol`` it latches ``converged`` when its drift reaches tol. A lane
    whose gate is closed on entry is left untouched, bit for bit. bf16
    storage is rounded once per chunk. Returns ``(P, colsum, frow, iters,
    converged)``.
    """
    L, M, N = P.shape if P.dim() == 3 else (0, 0, 0)
    _check_lanes(P, (colsum, (L, N), "colsum", torch.float32),
                 (frow, (L, M), "frow", torch.float32),
                 (iters, (L,), "iters", torch.int32),
                 (converged, (L,), "converged", torch.bool),
                 (active, (L,), "active", torch.bool),
                 (a, (L, M), "a", torch.float32),
                 (b, (L, N), "b", torch.float32))
    if ub._route(P) == "plain":
        return resident_stepped_plain(
            P, colsum, frow, iters, converged, active, a, b, fi=fi,
            n_iters=n_iters, num_iters=num_iters, tol=tol)
    ub._check_cuda(P, colsum, frow, iters, converged, active, a, b)
    if L == 0:
        return P, colsum, frow, iters, converged
    from repro_torch.kernels import _build
    lib = _build.load()
    code = lib.uot_resident_stepped(
        P.data_ptr(), colsum.data_ptr(), frow.data_ptr(), iters.data_ptr(),
        converged.data_ptr(), active.data_ptr(), a.data_ptr(), b.data_ptr(),
        L, M, N, _DTYPE_CODE[P.dtype], float(fi), int(fi == 1.0),
        int(n_iters), int(num_iters),
        float(tol) if tol is not None else 0.0, int(tol is not None),
        ub._stream())
    LAUNCHES["resident_stepped"] += 1
    _build.check(code, "resident_stepped")
    return P, colsum, frow, iters, converged


# ---- kernel k: the whole solve, the tile computed from coordinates ------------

def resident_solve_pc_plain(x, xn, y, yn, a, b, m_valid, n_valid, *,
                            fi: float, reg: float, scale: float = 1.0,
                            num_iters: int, tol: float | None = None,
                            out_dtype=torch.float32):
    """Plain version of kernel k: kernel f's plain version on the plain
    tile (``uot_geometry``'s, rounded through ``out_dtype``)."""
    from repro_torch.kernels.uot_geometry import _gibbs_stack
    PLAIN_CALLS["resident_solve_pc"] += 1
    A = _gibbs_stack(x, xn, y, yn, m_valid, n_valid, reg=reg, scale=scale,
                     dtype=out_dtype)
    return _solve_math(A, a, b, fi=fi, num_iters=num_iters, tol=tol)


def resident_solve_pc(x, xn, y, yn, a, b, m_valid, n_valid, *, fi: float,
                      reg: float, scale: float = 1.0, num_iters: int,
                      tol: float | None = None, out_dtype=torch.float32):
    """Whole-solve resident MAP-UOT for a point-cloud stack: each lane's
    Gibbs tile is computed in shared memory from its coordinates (x
    (B, M, d), xn (B, M), y (B, N, d), yn (B, N) fp32; m_valid, n_valid
    (B,) int32 valid counts masking the rest to exact zeros), then solved
    as kernel f solves a loaded tile. a (B, M), b (B, N) fp32. Returns
    ``(P, colsum, iters, err)`` like ``resident_solve``, P a new (B, M, N)
    tensor in ``out_dtype``."""
    from repro_torch.kernels import uot_geometry as ug
    B, M, N, d = ug._check_coords(x, xn, y, yn, m_valid, n_valid)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    ub._check_vec(a, (B, M), "a")
    ub._check_vec(b, (B, N), "b")
    if not lane_fits(M, N):
        raise ValueError(
            f"({M}, {N}) does not fit the resident kernels: a lane needs "
            f"{resident_smem_bytes(M, N)} bytes of shared memory, the limit "
            f"is {SMEM_LIMIT}; use impl='auto' to stream it")
    if ub._route(x) == "plain":
        return resident_solve_pc_plain(
            x, xn, y, yn, a, b, m_valid, n_valid, fi=fi, reg=reg,
            scale=scale, num_iters=num_iters, tol=tol, out_dtype=out_dtype)
    build, lib = ug._on_card(x, xn, y, yn, a, b, m_valid, n_valid)
    dev = x.device
    P = torch.empty((B, M, N), dtype=out_dtype, device=dev)
    colsum = torch.empty((B, N), dtype=torch.float32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return P, colsum, iters, err
    yt, ptrs, (reg_f, scale_f, scaled) = ug._gibbs_ptrs(
        x, xn, y, yn, m_valid, n_valid, reg, scale)
    code = lib.uot_resident_solve_pc(
        P.data_ptr(), a.data_ptr(), b.data_ptr(), *ptrs, colsum.data_ptr(),
        iters.data_ptr(), err.data_ptr(), B, M, N, d, _DTYPE_CODE[out_dtype],
        float(fi), int(fi == 1.0), int(num_iters),
        float(tol) if tol is not None else 0.0, int(tol is not None),
        reg_f, scale_f, scaled, ub._stream())
    LAUNCHES["resident_solve_pc"] += 1
    build.check(code, "resident_solve_pc")
    return P, colsum, iters, err
