"""Public solver entry points over the port's kernels (a-o).

The port of the dense half of ``repro.kernels.ops``:

* ``solve_fused`` — one problem, streamed: kernel a (``colsum``) once and
  kernel b (``fused_iteration``) per iteration for exactly
  ``cfg.num_iters`` iterations; ``impl='auto'`` / ``'resident'`` route it
  to the resident tier or, over budget, to ``solve_fused_batched`` at B=1
  with ``cfg.tol``;
* ``solve_fused_batched`` — a stack of same-shape problems, one kernel
  launch per iteration for the whole stack (kernel c for the initial
  column sums, kernel d per iteration; kernel e per iteration when
  ``cfg.tol`` freezes lanes one by one);
* ``solve_fused_resident`` — the whole solve of each lane in one launch
  of kernel f, the tile resident in shared memory;
* ``solve_fused_bucketed`` — a ragged problem list grouped into
  padded-shape buckets, each chunk solved by the batched or resident tier;
* ``LaneState`` + ``lane_admit`` / ``lane_evict`` / ``lane_done`` +
  ``solve_fused_stepped`` — the steppable lane pool the serving
  scheduler advances a chunk of iterations at a time (kernel e per
  iteration, or kernel g per chunk on the resident tier; kernel c for an
  admitted lane's initial column sums);
* ``solve_uv`` / ``solve_uv_batched`` — the POT u/v potential form, one
  read-only pass over K per iteration: kernel l (one problem) or n (a
  stack) per iteration and once more for the final u, then kernel m or o
  for the coupling.

``impl`` takes None or ``'kernel'`` (the streamed kernels), ``'resident'``
(the resident tier; a shape over its budget raises ``ValueError``) or
``'auto'`` (resident when ``resident_fits``, streamed otherwise; stepped
pools of sub-fp32 storage always stream). ``'auto'`` decisions are counted
(``dispatch_stats``, ``dispatch_counters``) and reported to
``dispatch_observer`` subscribers; a ``dispatch_advisor`` may turn a
resident-eligible shape to streamed.

Entry points run on the card unless the caller asks for the CPU
(``device=`` on the one-shot solvers and ``make_lane_state``; a pool's
functions follow the pool). Without CUDA the default raises. On a CPU
device every kernel wrapper takes its plain PyTorch version, which is how
the tests run the port against the JAX reference.

What differs from the reference, by design:

* **In place.** The fused passes overwrite the coupling, and the lane
  functions (``lane_admit``, ``lane_evict``, ``solve_fused_stepped``)
  update the pool's tensors in place and return the same ``LaneState``.
* **No alignment padding.** The CUDA kernels mask ragged edges, so
  ``make_lane_state(L, M, N)`` holds exactly (L, M, N) and the solvers
  pad nothing. ``bucket_shape``'s ``m_bucket`` / ``n_bucket`` keep their
  meaning (they decide which problems share a pool); the TPU's (8, 128)
  tiling and 32 MiB VMEM budget have no counterpart here —
  ``pick_block_m`` and ``resident_fits`` are Hopper's (shared memory per
  block, see ``uot_batched.plan_for`` and
  ``uot_resident.resident_smem_bytes``).
* **Host traffic.** Payloads cross to the card through pinned memory in
  one copy per batch; results come back the same way.

Cost geometries. ``geometry=`` on ``solve_fused``, ``solve_fused_batched``
and ``solve_fused_resident`` (exclusive with ``A0``) names the cost source
(``repro_torch.geometry``). Dense and grid geometries materialize their
Gibbs kernel once and take the dense path. A ``PointCloudGeometry`` never
has its kernel in device memory on the streamed path: kernel h takes the
initial column sums from the coordinates, kernel i runs iteration 1 and
writes the rescaled ``A1``, and kernels d / e take over from iteration 2
(kernel j materializes ``K`` only when ``num_iters == 0``); on the resident
tier kernel k computes each lane's tile in shared memory. On the same
coordinates the couplings equal the dense path's over the materialized
kernel (``geometry.kernel(reg)``), bit for bit in fp32 and bf16.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import numpy as np
import torch

from repro_torch.core.convergence import lane_factor_drift
from repro_torch.core.problem import UOTConfig, rescale_factors
from repro_torch.device import resolve_device
from repro_torch.geometry import Geometry, PointCloudGeometry
from repro_torch.kernels import (uot_batched, uot_fused, uot_geometry,
                                 uot_resident, uot_uv_fused)
from repro_torch.kernels.uot_batched import SMEM_LIMIT, pick_block_m

__all__ = [
    "pad_to", "pad_vec", "pick_block_m", "resident_fits", "dispatch_counters",
    "dispatch_observer", "dispatch_advisor", "dispatch_stats",
    "reset_dispatch_stats", "solve_fused", "solve_fused_resident",
    "solve_fused_stepped_resident", "solve_fused_batched",
    "solve_fused_bucketed", "bucket_shape", "bucket_problems",
    "canonical_batch", "bucketed_cache_stats", "reset_bucketed_cache_stats",
    "LaneState", "make_lane_state", "lane_admit", "lane_evict", "lane_done",
    "solve_fused_stepped", "solve_uv", "solve_uv_batched", "to_device",
    "to_host",
]

# how often the tol batched solve reads back "all lanes converged"
_CONV_CHECK_EVERY = 4


def _check_impl(impl) -> None:
    if impl not in (None, "kernel", "auto", "resident"):
        raise ValueError(f"impl must be None, 'kernel', 'auto' or "
                         f"'resident', got {impl!r}")


def _storage(cfg: UOTConfig, storage_dtype) -> torch.dtype:
    sdt = storage_dtype if storage_dtype is not None else cfg.dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"storage dtype must be torch.float32 or "
                        f"torch.bfloat16, got {sdt}")
    return sdt


# ---- the resident tier's budget and the impl='auto' dispatch ----------------

def resident_fits(M: int, N: int, cfg: UOTConfig, *,
                  storage_dtype=None) -> bool:
    """Whether an (M, N) problem can run on the resident tier (kernels f,
    g and k) of this card.

    Rebuilt for Hopper: a lane runs in one block, whose shared memory
    (``SMEM_LIMIT`` = 232,448 bytes on an H100) holds only the fp32
    working tile, ``M*N*4`` bytes, plus the O(M + N) vectors and the
    reduction scratch (``uot_resident.resident_smem_bytes``). The storage
    tile is read from and written to device memory directly, so fp32 and
    bf16 storage have the same budget, and there is no (8, 128) padding.
    For example 128x384 fits (200,832 bytes) and 256x256 does not. The
    reference's 32 MiB VMEM model (in and out tiles double-buffered) has
    no counterpart. The test is static, and the batch size does not enter
    it: each lane is its own block.

    The same budget holds for kernel k (a point-cloud geometry's tile
    computed from coordinates): k writes the computed tile into f's fp32
    working tile and stages nothing else. The reference widens its
    implicit budget (``Mp*Np*(s + 8)`` against the dense
    ``Mp*Np*(2s + 8)``) because there the dense kernel double-buffers an
    *input* tile in VMEM that the implicit one does not need: a TPU fact.
    Kernel f never holds an input tile in shared memory, so on Hopper
    there is nothing to drop.
    """
    _storage(cfg, storage_dtype)
    return uot_resident.lane_fits(M, N)


# ``impl='auto'`` routing decisions, observable so the dispatch boundary is
# assertable in tests and visible in benchmarks. Only 'auto' counts: an
# explicit impl is the caller's decision. The counters are per context: the
# module-global dict is the base of a contextvar-held stack, and
# ``dispatch_counters()`` pushes a fresh dict for the extent of a ``with``
# block. Every decision increments every dict on the stack, and
# ``dispatch_stats()`` / ``reset_dispatch_stats()`` address the innermost
# scope, so two schedulers (or two tests) observe their own decisions.
_DISPATCH_GLOBAL = {"resident": 0, "streamed": 0}
_DISPATCH_CTX: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "uot_torch_dispatch_counters", default=(_DISPATCH_GLOBAL,))
_DISPATCH_OBS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "uot_torch_dispatch_observers", default=())
_DISPATCH_ADVISORS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "uot_torch_dispatch_advisors", default=())


@contextlib.contextmanager
def dispatch_counters():
    """Isolated ``impl='auto'`` decision counters for a ``with`` block:
    yields a ``{'resident': 0, 'streamed': 0}`` dict that counts only the
    decisions made inside the block (in this thread / task); enclosing
    scopes keep counting too."""
    counters = {"resident": 0, "streamed": 0}
    token = _DISPATCH_CTX.set(_DISPATCH_CTX.get() + (counters,))
    try:
        yield counters
    finally:
        _DISPATCH_CTX.reset(token)


@contextlib.contextmanager
def dispatch_observer(cb):
    """Subscribe ``cb(kind, M=, N=, itemsize=, num_iters=)`` to
    every ``impl='auto'`` routing decision made in the extent of the
    ``with`` block (this thread / task). ``kind`` is ``'resident'`` or
    ``'streamed'``; ``itemsize`` is the resolved storage dtype's;
    ``num_iters`` the config's iteration budget. Observers stack like the
    counters."""
    token = _DISPATCH_OBS.set(_DISPATCH_OBS.get() + (cb,))
    try:
        yield cb
    finally:
        _DISPATCH_OBS.reset(token)


@contextlib.contextmanager
def dispatch_advisor(advisor):
    """Install ``advisor.advise(M=, N=, itemsize=, stepped=) ->
    'resident' | 'streamed' | None`` for ``impl='auto'`` resolutions in the
    extent of the ``with`` block. The innermost advisor with an opinion
    wins; None defers to ``resident_fits``. Advice is taken only where the
    budget already allows resident: an advisor can send a resident-eligible
    shape to the streamed tier, never the reverse."""
    token = _DISPATCH_ADVISORS.set(_DISPATCH_ADVISORS.get() + (advisor,))
    try:
        yield advisor
    finally:
        _DISPATCH_ADVISORS.reset(token)


def dispatch_stats() -> dict:
    """{'resident': ..., 'streamed': ...} decisions made by ``impl='auto'``
    in the innermost ``dispatch_counters()`` scope (the process-wide totals
    outside any scope)."""
    return dict(_DISPATCH_CTX.get()[-1])


def reset_dispatch_stats() -> None:
    """Zero the innermost scope's counters."""
    _DISPATCH_CTX.get()[-1].update(resident=0, streamed=0)


def _resolve_auto(impl, M: int, N: int, cfg: UOTConfig, storage_dtype, *,
                  stepped_sdt=None) -> bool:
    """Resolve 'auto' / 'resident' to a tier for an (M, N) problem; True
    routes resident.

    For a stepped pool pass its storage dtype as ``stepped_sdt``: sub-fp32
    pools never route resident under 'auto', because kernel g rounds the
    tile once per chunk instead of once per iteration, which would make a
    bf16 lane's iterates depend on chunk boundaries (explicit 'resident'
    still allows it). 'resident' over budget raises ``ValueError``.
    """
    fits = resident_fits(M, N, cfg, storage_dtype=storage_dtype)
    if impl == "resident":
        if not fits:
            raise ValueError(
                f"({M}, {N}) exceeds the resident budget (one block's "
                f"shared memory, {SMEM_LIMIT} bytes); use impl='auto' to "
                f"fall back to the streamed tier")
        return True
    sdt = _storage(cfg, stepped_sdt if stepped_sdt is not None
                   else storage_dtype)
    s = sdt.itemsize
    resident = fits and not (stepped_sdt is not None and s < 4)
    if resident:
        for adv in reversed(_DISPATCH_ADVISORS.get()):
            choice = adv.advise(M=M, N=N, itemsize=s,
                                stepped=stepped_sdt is not None)
            if choice in ("resident", "streamed"):
                resident = choice == "resident"
                break
    kind = "resident" if resident else "streamed"
    for counters in _DISPATCH_CTX.get():
        counters[kind] += 1
    for cb in _DISPATCH_OBS.get():
        cb(kind, M=M, N=N, itemsize=s, num_iters=cfg.num_iters)
    return resident


# ---- host <-> device ---------------------------------------------------------

def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` that owns its memory: one
    copy through pinned memory to the card, or a copy on the CPU (so the
    in-place solvers never write into a caller's array)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU: one copy into pinned memory, then a sync."""
    if t.device.type != "cuda":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return h


def _np_f32(t: torch.Tensor) -> np.ndarray:
    """Host tensor -> float32 numpy (bf16 is upcast exactly)."""
    return t.float().numpy() if t.dtype != torch.float32 else t.numpy()


# ---- padding -----------------------------------------------------------------

def pad_to(x: torch.Tensor, m_mult: int, n_mult: int) -> torch.Tensor:
    """Zero-pad the last two dims to multiples (works for 2-D and 3-D)."""
    M, N = x.shape[-2:]
    pm, pn = (-M) % m_mult, (-N) % n_mult
    if pm or pn:
        x = torch.nn.functional.pad(x, (0, pn, 0, pm))
    return x


def pad_vec(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the last dim to a multiple (works for (M,) and (B, M))."""
    p = (-x.shape[-1]) % mult
    return torch.nn.functional.pad(x, (0, p)) if p else x


# ---- one iteration -----------------------------------------------------------

def _stepped_iter(A, colsum, upd, *, ap, bp, fi):
    """One (optionally masked) batched Algorithm-1 iteration, in place.

    ``upd`` is a (B,) bool lane mask or None. With None every lane is
    updated by kernel d and no row factors are produced. With a mask,
    kernel e updates live lanes and leaves frozen lanes' tile and carried
    column sums untouched (the reference's re-select, for free).

    Returns (A, colsum, frow); frow (B, M) holds live lanes' factors (None
    without a mask); callers mask frozen lanes' rows.
    """
    fcol = rescale_factors(bp, colsum, fi)
    if upd is None:
        A, colsum = uot_batched.batched_fused_iteration(A, fcol, ap, fi=fi)
        return A, colsum, None
    return uot_batched.batched_fused_iteration_frow(A, fcol, ap, upd, colsum,
                                                    fi=fi)


# ---- one problem -------------------------------------------------------------

def solve_fused(A0, a, b, cfg: UOTConfig, *, storage_dtype=None,
                impl: str | None = None, geometry=None, device=None):
    """MAP-UOT solve of one (M, N) problem on ``device`` (default the card).

    A0: (M, N); a: (M,); b: (N,) — numpy arrays or tensors, copied to the
    device in the storage dtype (``storage_dtype``, default ``cfg.dtype``);
    every sum and factor is fp32. Returns (P, colsum) tensors of shapes
    (M, N) and (N,).

    ``impl``: None / 'kernel' stream the coupling through kernels a and b
    for exactly ``cfg.num_iters`` iterations and ignore ``cfg.tol``, as the
    reference's default path does. 'resident' runs the whole solve on
    kernel f and honours ``cfg.tol``; a shape over ``resident_fits``
    raises ``ValueError``. 'auto' picks by ``resident_fits`` and, over
    budget, streams through ``solve_fused_batched`` at B=1 *with*
    ``cfg.tol``, so results differ by tier in traffic, never in math.

    ``geometry=`` (exclusive with ``A0``) sources the initial coupling
    from a ``repro_torch.geometry.Geometry``, ``A0 = K = exp(-C / reg)``.
    The solve is routed through ``solve_fused_batched`` at B=1, so it has
    ``cfg.tol`` early-exit semantics under every ``impl``.
    """
    _check_impl(impl)
    if geometry is not None:
        if A0 is not None:
            raise ValueError("pass either A0 or geometry=, not both")
        P, colsum = solve_fused_batched(
            None, _lead(a), _lead(b), cfg, storage_dtype=storage_dtype,
            impl=impl, geometry=geometry, device=device)
        return P[0], colsum[0]
    if impl in ("auto", "resident"):
        M, N = np.shape(A0)
        if _resolve_auto(impl, M, N, cfg, storage_dtype):
            P, colsum, _, _ = solve_fused_resident(
                A0, a, b, cfg, storage_dtype=storage_dtype, device=device)
            return P, colsum
        P, colsum = solve_fused_batched(
            _lead(A0), _lead(a), _lead(b), cfg, storage_dtype=storage_dtype,
            device=device)
        return P[0], colsum[0]
    dev = resolve_device(device)
    A = to_device(A0, dev).to(_storage(cfg, storage_dtype))
    return _solve_fused_streamed(A, to_device(a, dev).float(),
                                 to_device(b, dev).float(), cfg)


def _lead(x):
    """``x`` with a leading batch axis of one (numpy or tensor)."""
    return x[None] if isinstance(x, torch.Tensor) else np.asarray(x)[None]


def _solve_fused_streamed(A, a, b, cfg: UOTConfig):
    """Exactly ``cfg.num_iters`` streamed iterations, in place on ``A``:
    kernel a for the initial column sums, kernel b per iteration."""
    fi = cfg.fi
    colsum = uot_fused.colsum(A)
    for _ in range(cfg.num_iters):
        fcol = rescale_factors(b, colsum, fi)
        A, colsum = uot_fused.fused_iteration(A, fcol, a, fi=fi)
    return A, colsum


# ---- one-shot batched solve --------------------------------------------------

def solve_fused_batched(A0, a, b, cfg: UOTConfig, *, storage_dtype=None,
                        impl: str | None = None, geometry=None, device=None):
    """MAP-UOT solve for a stack of same-shape problems.

    A0: (B, M, N); a: (B, M); b: (B, N) — numpy arrays or tensors. The
    stack is copied to ``device`` (default the card) in the storage dtype
    (``storage_dtype``, default ``cfg.dtype``); every sum and factor is
    fp32. Returns (P, colsum) tensors of shapes (B, M, N) and (B, N) on
    that device.

    With ``cfg.tol`` set the solve early-exits per lane: a lane whose
    row-factor stationarity drift falls to ``tol`` is frozen at exactly
    that iterate, and the loop ends when every lane has converged (read
    back every few iterations) or ``num_iters`` is hit. ``impl='resident'``
    runs the whole solve on kernel f (bf16 storage is rounded once at the
    end instead of every iteration); ``impl='auto'`` picks the tier by
    ``resident_fits``.

    ``geometry=`` (exclusive with ``A0``) sources the initial coupling
    from a ``Geometry``. A ``PointCloudGeometry`` (batched coordinates,
    optional per-problem valid counts) streams through kernels h, i and
    then d / e, or runs on kernel k where ``impl='auto'`` / ``'resident'``
    route it resident; dense and grid geometries materialize their kernel
    and take the dense path.
    """
    _check_impl(impl)
    if geometry is not None:
        if A0 is not None:
            raise ValueError("pass either A0 or geometry=, not both")
        return _solve_fused_batched_geometry(
            geometry, a, b, cfg, storage_dtype=storage_dtype, impl=impl,
            device=device)
    if impl in ("auto", "resident"):
        _, M, N = np.shape(A0)
        if _resolve_auto(impl, M, N, cfg, storage_dtype):
            P, colsum, _, _ = solve_fused_resident(
                A0, a, b, cfg, storage_dtype=storage_dtype, device=device)
            return P, colsum
    dev = resolve_device(device)
    sdt = _storage(cfg, storage_dtype)
    A = to_device(A0, dev).to(sdt)
    a = to_device(a, dev).float()
    b = to_device(b, dev).float()
    return _solve_fused_batched_streamed(A, a, b, cfg)


def _solve_fused_batched_streamed(A, a, b, cfg: UOTConfig):
    colsum = uot_batched.batched_colsum(A)
    conv = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
    return _streamed_loop(A, colsum, a, b, cfg, first=0,
                          prev_frow=torch.ones_like(a), conv=conv)


def _streamed_loop(A, colsum, a, b, cfg: UOTConfig, *, first: int,
                   prev_frow, conv):
    """Iterations ``first .. cfg.num_iters - 1`` of the batched streamed
    solve, in place: kernel d per iteration, or with ``cfg.tol`` kernel e
    with the lanes frozen one by one (``prev_frow`` / ``conv`` carry the
    row factors and convergence of iteration ``first - 1``)."""
    fi = cfg.fi
    if cfg.tol is None:
        for _ in range(first, cfg.num_iters):
            A, colsum, _ = _stepped_iter(A, colsum, None, ap=a, bp=b, fi=fi)
        return A, colsum
    for i in range(first, cfg.num_iters):
        if i % _CONV_CHECK_EVERY == 0 and bool(conv.all()):
            break
        upd = ~conv
        A, colsum, frow = _stepped_iter(A, colsum, upd, ap=a, bp=b, fi=fi)
        drift = lane_factor_drift(frow, prev_frow)
        prev_frow = torch.where(upd[:, None], frow, prev_frow)
        conv = conv | (upd & (drift <= cfg.tol))
    return A, colsum


# ---- the resident tier --------------------------------------------------------

def solve_fused_resident(A0, a, b, cfg: UOTConfig, *, storage_dtype=None,
                         geometry=None, device=None):
    """Whole-solve resident MAP-UOT on kernel f: load once, iterate,
    store once.

    A0 may be (M, N) or (B, M, N) (a, b matching), numpy or tensors,
    copied to ``device`` (default the card) in the storage dtype. Each
    lane honours ``cfg.tol`` with the streamed solvers' row-factor
    stationarity criterion: same iterate, same iteration count. Raises
    ``ValueError`` for a shape over ``resident_fits``.

    ``geometry=`` (exclusive with ``A0``) sources the tile from a
    ``Geometry``: a ``PointCloudGeometry`` runs on kernel k, each lane's
    tile computed in shared memory from its coordinates (per solve: the
    coordinates in, M*N out); dense and grid geometries materialize their
    kernel first.

    Returns (P, colsum, iters, err), with a leading batch axis only if A0
    had one (the marginals, under ``geometry=``).
    """
    if geometry is not None:
        if A0 is not None:
            raise ValueError("pass either A0 or geometry=, not both")
        return _solve_fused_resident_geometry(
            geometry, a, b, cfg, storage_dtype=storage_dtype, device=device)
    single = len(np.shape(A0)) == 2
    M, N = np.shape(A0)[-2:]
    if not resident_fits(M, N, cfg, storage_dtype=storage_dtype):
        raise ValueError(
            f"({M}, {N}) exceeds the resident budget (one block's shared "
            f"memory, {SMEM_LIMIT} bytes); use impl='auto' to fall back to "
            f"the streamed tier")
    dev = resolve_device(device)
    A = to_device(A0, dev).to(_storage(cfg, storage_dtype))
    a = to_device(a, dev).float()
    b = to_device(b, dev).float()
    if single:
        A, a, b = A[None], a[None], b[None]
    P, colsum, iters, err = uot_resident.resident_solve(
        A, a.contiguous(), b.contiguous(), fi=cfg.fi,
        num_iters=cfg.num_iters, tol=cfg.tol)
    if single:
        return P[0], colsum[0], iters[0], err[0]
    return P, colsum, iters, err


# ---- cost geometries ---------------------------------------------------------

def _require_geometry(geom) -> None:
    if not isinstance(geom, Geometry):
        raise TypeError(f"geometry= expects a repro_torch.geometry.Geometry, "
                        f"got {type(geom).__name__}")


def _marginals(a, b, dev):
    return (to_device(a, dev).float().contiguous(),
            to_device(b, dev).float().contiguous())


def _solve_fused_batched_geometry(geom, a, b, cfg: UOTConfig, *,
                                  storage_dtype=None, impl=None, device=None):
    """Route a batched geometry solve: a point cloud to kernel k (when
    'auto' / 'resident' resolve resident) or to the streamed h, i, d / e
    path; dense and grid geometries to the dense path on their kernel."""
    _require_geometry(geom)
    B = np.shape(a)[0]
    if not isinstance(geom, PointCloudGeometry):
        A0 = geom.kernel(cfg.reg)
        if A0.dim() == 2:
            A0 = A0.expand((B,) + tuple(A0.shape)).contiguous()
        return solve_fused_batched(A0, a, b, cfg, storage_dtype=storage_dtype,
                                   impl=impl, device=device)
    geom = geom.batched()
    if geom.x.shape[0] != B:
        raise ValueError(f"geometry batch {geom.x.shape[0]} != marginal "
                         f"batch {B}")
    M, N = geom.shape
    if impl in ("auto", "resident") and _resolve_auto(
            impl, M, N, cfg, storage_dtype):
        P, colsum, _, _ = solve_fused_resident(
            None, a, b, cfg, storage_dtype=storage_dtype, geometry=geom,
            device=device)
        return P, colsum
    dev = resolve_device(device)
    a, b = _marginals(a, b, dev)
    return _solve_fused_batched_geometry_streamed(
        geom.operands(dev), a, b, cfg, _storage(cfg, storage_dtype),
        geom.scale)


def _solve_fused_batched_geometry_streamed(operands, a, b, cfg: UOTConfig,
                                           sdt: torch.dtype, scale: float):
    """The streamed batched solve with the Gibbs kernel computed on the
    card: kernel h for the initial column sums, kernel i for iteration 1
    (its first M*N write is the rescaled A1), then kernels d / e as on the
    dense path — the same bookkeeping, the first iteration's drift taken
    against unit factors — so the iterates equal the dense path's over
    ``geometry.kernel(reg)``. ``num_iters == 0`` materializes the kernel
    with kernel j."""
    kw = dict(reg=float(cfg.reg), scale=scale)
    colsum0 = uot_geometry.batched_pc_colsum(*operands, storage_dtype=sdt,
                                             **kw)
    if cfg.num_iters == 0:
        return (uot_geometry.batched_pc_materialize(*operands, out_dtype=sdt,
                                                    **kw), colsum0)
    fcol = rescale_factors(b, colsum0, cfg.fi)
    A, colsum, frow1 = uot_geometry.batched_pc_first_iteration(
        fcol, a, *operands, fi=cfg.fi, out_dtype=sdt, **kw)
    conv = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
    if cfg.tol is not None:
        conv = lane_factor_drift(frow1, torch.ones_like(a)) <= cfg.tol
    return _streamed_loop(A, colsum, a, b, cfg, first=1, prev_frow=frow1,
                          conv=conv)


def _solve_fused_resident_geometry(geom, a, b, cfg: UOTConfig, *,
                                   storage_dtype=None, device=None):
    """The resident tier with the tile sourced from a ``Geometry``."""
    _require_geometry(geom)
    if not isinstance(geom, PointCloudGeometry):
        A0 = geom.kernel(cfg.reg)
        if A0.dim() == 2 and len(np.shape(a)) == 2:
            A0 = A0.expand((np.shape(a)[0],) + tuple(A0.shape)).contiguous()
        return solve_fused_resident(A0, a, b, cfg,
                                    storage_dtype=storage_dtype,
                                    device=device)
    single = len(np.shape(a)) == 1
    if single:
        a, b = _lead(a), _lead(b)
    geom = geom.batched()
    B = np.shape(a)[0]
    if geom.x.shape[0] != B:
        raise ValueError(f"geometry batch {geom.x.shape[0]} != marginal "
                         f"batch {B}")
    M, N = geom.shape
    if not resident_fits(M, N, cfg, storage_dtype=storage_dtype):
        raise ValueError(
            f"({M}, {N}) exceeds the resident budget (one block's shared "
            f"memory, {SMEM_LIMIT} bytes); use impl='auto' to fall back to "
            f"the streamed tier")
    dev = resolve_device(device)
    a, b = _marginals(a, b, dev)
    x, xn, y, yn, mv, nv = geom.operands(dev)
    P, colsum, iters, err = uot_resident.resident_solve_pc(
        x, xn, y, yn, a, b, mv, nv, fi=cfg.fi, reg=float(cfg.reg),
        scale=geom.scale, num_iters=cfg.num_iters, tol=cfg.tol,
        out_dtype=_storage(cfg, storage_dtype))
    if single:
        return P[0], colsum[0], iters[0], err[0]
    return P, colsum, iters, err


# ---- the u/v potential form ---------------------------------------------------

def _uv_operand(K, dev: torch.device) -> torch.Tensor:
    """K on ``dev`` in its own storage type: the u/v kernels only read it,
    so a contiguous tensor already there is used as it is. bf16 stays bf16;
    any other type becomes fp32 (as JAX promotes it against fp32 ``v``)."""
    K = K.to(dev) if isinstance(K, torch.Tensor) else to_device(K, dev)
    if K.dtype != torch.bfloat16:
        K = K.float()
    return K.contiguous()


def solve_uv(K, a, b, cfg: UOTConfig, *, materialize: bool = True,
             device=None):
    """Read-only-pass u/v solve of one (M, N) problem (POT semantics:
    ``u = (a / K v) ** fi``, ``v = (b / K^T u) ** fi``) on ``device``
    (default the card).

    K: (M, N) numpy array or tensor, read in its own storage type (a bf16
    tensor takes the bf16 path; the sums, u and v are fp32); a: (M,); b:
    (N,). Exactly ``cfg.num_iters`` iterations of kernel l, ``cfg.tol``
    ignored, as the reference's ``ops.solve_uv``; one extra pass of l gives
    the final u consistent with v (its ``K^T u`` is not used), and kernel m
    the coupling. Returns ``(P or None, (u, v))``: P (M, N) fp32 (None with
    ``materialize=False``), u (M,), v (N,). Rows wider than one block's
    column accumulator raise ``ValueError`` on every device (the wide-N
    half-pass kernels are a later slice).
    """
    dev = resolve_device(device)
    K = _uv_operand(K, dev)
    if K.dim() != 2:
        raise ValueError(f"K must be (M, N), got {tuple(K.shape)}")
    M, N = K.shape
    uot_batched.plan_for(1, M, N, K.element_size())
    a, b = _marginals(a, b, dev)
    fi = cfg.fi
    v = torch.ones(N, dtype=torch.float32, device=dev)
    for _ in range(cfg.num_iters):
        _, ktu = uot_uv_fused.uv_iteration(K, v, a, fi=fi)
        v = rescale_factors(b, ktu, fi)
    u, _ = uot_uv_fused.uv_iteration(K, v, a, fi=fi)
    P = uot_uv_fused.materialize_coupling(K, u, v) if materialize else None
    return P, (u, v)


def solve_uv_batched(K, a, b, cfg: UOTConfig, *, materialize: bool = True,
                     impl: str | None = None, device=None):
    """Batched read-only-pass u/v solve: K (B, M, N), a (B, M), b (B, N).

    As ``solve_uv`` over a stack, on kernels n (per iteration and for the
    final u) and o (the coupling). ``impl`` is None or ``'kernel'``: there
    is no resident tier, since the u/v pass is read-only and its streamed
    form already moves only M*N read bytes per iteration; the reference's
    ``impl='jnp'`` is ``device='cpu'`` here. Returns ``(P or None, (u,
    v))`` with P (B, M, N) fp32, u (B, M), v (B, N).
    """
    if impl not in (None, "kernel"):
        raise ValueError(f"solve_uv_batched has no resident tier; impl must "
                         f"be None or 'kernel' (the reference's 'jnp' is "
                         f"device='cpu'), got {impl!r}")
    dev = resolve_device(device)
    K = _uv_operand(K, dev)
    if K.dim() != 3:
        raise ValueError(f"K must be (B, M, N), got {tuple(K.shape)}")
    B, M, N = K.shape
    uot_batched.plan_for(B, M, N, K.element_size())
    a, b = _marginals(a, b, dev)
    fi = cfg.fi
    v = torch.ones((B, N), dtype=torch.float32, device=dev)
    for _ in range(cfg.num_iters):
        _, ktu = uot_batched.batched_uv_iteration(K, v, a, fi=fi)
        v = rescale_factors(b, ktu, fi)
    u, _ = uot_batched.batched_uv_iteration(K, v, a, fi=fi)
    P = (uot_batched.batched_materialize_coupling(K, u, v) if materialize
         else None)
    return P, (u, v)


# ---- steppable solving: explicit carried state for continuous batching -------

@dataclasses.dataclass
class LaneState:
    """Carried state of a fixed pool of batched solver lanes.

    A *lane* is one slot of an (L, M, N) problem stack; the pool is
    advanced a chunk of Algorithm-1 iterations at a time by
    ``solve_fused_stepped`` and a scheduler evicts finished lanes and
    admits queued problems between chunks. Free lanes hold all-zero
    problems, exact no-ops for the rescaling math, and per-lane math is
    independent of what shares the pool. The functions of this module
    update the tensors in place.

    Fields (tensors on the pool's device):
      P:         (L, M, N) coupling iterate, storage dtype (fp32 or bf16).
      colsum:    (L, N) fp32 carried column sums (valid for the next
                 column rescale).
      a, b:      (L, M) / (L, N) fp32 marginals, zero-padded.
      frow:      (L, M) fp32 row factors of the lane's previous iteration
                 (ones at admission); successive frows give the drift.
      iters:     (L,) int32 iterations run since admission.
      converged: (L,) bool — the drift fell to ``cfg.tol``.
      active:    (L,) bool — the lane holds a live problem.
      healthy:   (L,) bool — latched False when the lane's row factors or
                 carried column sums go non-finite; the lane then freezes
                 like a converged one and reads as finished.
      m_valid:   (L,) int32 valid row count (0 for a free lane).
      n_valid:   (L,) int32 valid column count.
    """

    P: torch.Tensor
    colsum: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    frow: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    active: torch.Tensor
    m_valid: torch.Tensor
    n_valid: torch.Tensor
    healthy: torch.Tensor

    @property
    def num_lanes(self) -> int:
        return self.P.shape[0]

    @property
    def device(self) -> torch.device:
        return self.P.device


def make_lane_state(num_lanes: int, M: int, N: int, cfg: UOTConfig, *,
                    storage_dtype=None, device=None) -> LaneState:
    """Empty lane pool for problems of shape up to (M, N), on ``device``
    (default the card). The pool is exactly (num_lanes, M, N): the kernels
    mask ragged edges, so there is no alignment padding."""
    dev = resolve_device(device)
    sdt = _storage(cfg, storage_dtype)
    L = num_lanes
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    bool_ = dict(dtype=torch.bool, device=dev)
    return LaneState(
        P=torch.zeros((L, M, N), dtype=sdt, device=dev),
        colsum=torch.zeros((L, N), **f32),
        a=torch.zeros((L, M), **f32),
        b=torch.zeros((L, N), **f32),
        frow=torch.ones((L, M), **f32),
        iters=torch.zeros(L, **i32),
        converged=torch.zeros(L, **bool_),
        active=torch.zeros(L, **bool_),
        m_valid=torch.zeros(L, **i32),
        n_valid=torch.zeros(L, **i32),
        healthy=torch.ones(L, **bool_))


def _pad_admit_payload(Mp: int, Np: int, K: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, m_valid, n_valid,
                       storage_dtype: torch.dtype):
    """Zero-pad (and validity-mask) an admission payload to a pool shape.

    K (k, M, N), a (k, M), b (k, N) on the pool's device; ``m_valid`` /
    ``n_valid`` are optional per-problem valid counts (int or (k,)),
    default the payload's own M, N. Returns (Kp, ap, bp, mv, nv) at
    (Mp, Np) with everything beyond the valid counts exactly 0.0.
    """
    k, M, N = K.shape
    if M > Mp or N > Np:
        raise ValueError(f"payload ({M}, {N}) does not fit the pool "
                         f"({Mp}, {Np})")
    dev = K.device
    mv = torch.as_tensor(M if m_valid is None else m_valid,
                         dtype=torch.int32, device=dev).expand(k).clone()
    nv = torch.as_tensor(N if n_valid is None else n_valid,
                         dtype=torch.int32, device=dev).expand(k).clone()
    if (M, N) == (Mp, Np):
        Kp = K.to(storage_dtype)
        ap, bp = a.float(), b.float()
    else:
        Kp = torch.zeros((k, Mp, Np), dtype=storage_dtype, device=dev)
        Kp[:, :M, :N] = K
        ap = torch.zeros((k, Mp), dtype=torch.float32, device=dev)
        ap[:, :M] = a
        bp = torch.zeros((k, Np), dtype=torch.float32, device=dev)
        bp[:, :N] = b
    if m_valid is not None or n_valid is not None:
        rmask = torch.arange(Mp, device=dev)[None, :] < mv[:, None]
        cmask = torch.arange(Np, device=dev)[None, :] < nv[:, None]
        Kp = torch.where(rmask[:, :, None] & cmask[:, None, :], Kp,
                         torch.zeros((), dtype=Kp.dtype, device=dev))
        ap = torch.where(rmask, ap, 0.0)
        bp = torch.where(cmask, bp, 0.0)
    return Kp, ap, bp, mv, nv


def _as_lane_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return to_device(np.asarray(x, np.float32), device)


def lane_admit(state: LaneState, lane, K, a, b, m_valid=None,
               n_valid=None) -> LaneState:
    """Load one problem — or a batch — into lane(s) ``lane``, in place.

    ``lane`` is an int (K (M, N), a (M,), b (N,)) or a sequence / (k,)
    tensor of ints (K (k, M, N), a (k, M), b (k, N)); payloads may be
    numpy arrays or tensors and are zero-padded to the pool shape. The
    carried column sums are computed by kernel c from the *stored*
    (possibly bf16) matrix, so a lane's trajectory equals
    ``solve_fused_batched`` on the same problem. ``m_valid`` / ``n_valid``
    record — and enforce, by zeroing the payload beyond them — each
    problem's live extent.
    """
    dev = state.device
    idx = torch.as_tensor(lane, dtype=torch.long).reshape(-1).to(dev)
    K = _as_lane_tensor(K, dev)
    a = _as_lane_tensor(a, dev)
    b = _as_lane_tensor(b, dev)
    if K.dim() == 2:
        K, a, b = K[None], a[None], b[None]
    Mp, Np = state.P.shape[1:]
    Kp, ap, bp, mv, nv = _pad_admit_payload(Mp, Np, K, a, b, m_valid,
                                            n_valid, state.P.dtype)
    state.colsum[idx] = uot_batched.batched_colsum(Kp.contiguous())
    state.P[idx] = Kp
    state.a[idx] = ap
    state.b[idx] = bp
    state.frow[idx] = 1.0
    state.iters[idx] = 0
    state.converged[idx] = False
    state.active[idx] = True
    state.m_valid[idx] = mv
    state.n_valid[idx] = nv
    state.healthy[idx] = True
    return state


def lane_evict(state: LaneState, lane) -> LaneState:
    """Free lane(s) ``lane`` (int or sequence / tensor of ints), in place:
    zero the problem(s) and drop the active flag. Zeroing is also what
    scrubs a poisoned lane's NaNs out of the pool."""
    idx = torch.as_tensor(lane, dtype=torch.long).reshape(-1).to(
        state.device)
    for t in (state.P, state.colsum, state.a, state.b, state.iters,
              state.m_valid, state.n_valid):
        t[idx] = 0
    state.frow[idx] = 1.0
    state.converged[idx] = False
    state.active[idx] = False
    state.healthy[idx] = True
    return state


def lane_done(state: LaneState, max_iters: int) -> torch.Tensor:
    """(L,) bool: lane holds a finished problem — converged, at the cap,
    or frozen unhealthy."""
    return state.active & (state.converged | (state.iters >= max_iters)
                           | ~state.healthy)


def solve_fused_stepped(state: LaneState, n_iters: int, cfg: UOTConfig, *,
                        impl: str | None = None) -> LaneState:
    """Advance every unfinished lane by up to ``n_iters`` iterations, in
    place (the steppable form of ``solve_fused_batched``).

    Per iteration a lane is updated iff it is active, healthy, not yet
    converged and below ``cfg.num_iters``; with ``cfg.tol`` a lane whose
    drift reaches tol has ``converged`` latched and is frozen at exactly
    that iterate, so its answer does not depend on chunk boundaries or on
    what shares the pool. Nothing is read back to the host. None /
    'kernel' stream the pool through kernel e every iteration;
    'resident' runs the chunk on kernel g (``solve_fused_stepped_resident``)
    and 'auto' routes by ``resident_fits`` — fp32 pools only, since kernel
    g rounds sub-fp32 storage once per chunk rather than once per
    iteration.
    """
    _check_impl(impl)
    if impl in ("auto", "resident"):
        M, N = state.P.shape[1:]
        if _resolve_auto(impl, M, N, cfg, state.P.dtype,
                         stepped_sdt=state.P.dtype):
            return solve_fused_stepped_resident(state, n_iters, cfg)
    return _solve_fused_stepped_streamed(state, n_iters, cfg)


def solve_fused_stepped_resident(state: LaneState, n_iters: int,
                                 cfg: UOTConfig) -> LaneState:
    """``solve_fused_stepped`` on kernel g: one launch advances every live
    lane up to ``n_iters`` iterations with its tile in shared memory (read
    and write M*N per chunk instead of per iteration), in place. Per-lane
    gating and the tol freeze run inside the kernel, so iterates, counts
    and chunk-boundary behaviour match the streamed path for fp32 pools;
    bf16 pools are rounded once per chunk.

    Unhealthy lanes enter the kernel as converged, so it leaves them
    untouched. Fresh poison is caught once per chunk from the returned
    frow and colsum (O(L*(M+N)) values; the tile is never rescanned): a
    lane that goes non-finite mid-chunk runs out its own chunk before it
    freezes, while the streamed path catches it the same iteration.
    """
    st = state
    M, N = st.P.shape[1:]
    if not resident_fits(M, N, cfg, storage_dtype=st.P.dtype):
        raise ValueError(
            f"({M}, {N}) lane pool exceeds the resident budget (one "
            f"block's shared memory, {SMEM_LIMIT} bytes); use impl='auto' "
            f"to fall back to the streamed tier")
    ran = (st.active & st.healthy & ~st.converged
           & (st.iters < cfg.num_iters))
    conv = st.converged | ~st.healthy
    uot_resident.resident_stepped(
        st.P, st.colsum, st.frow, st.iters, conv, st.active, st.a, st.b,
        fi=cfg.fi, n_iters=n_iters, num_iters=cfg.num_iters, tol=cfg.tol)
    finite = (torch.isfinite(st.frow).all(dim=-1)
              & torch.isfinite(st.colsum).all(dim=-1))
    healthy = st.healthy & (finite | ~ran)
    st.converged = torch.where(st.healthy, conv, st.converged) & healthy
    st.healthy = healthy
    return st


def _solve_fused_stepped_streamed(st: LaneState, n_iters: int,
                                  cfg: UOTConfig) -> LaneState:
    fi = cfg.fi
    for _ in range(n_iters):
        upd = (st.active & ~st.converged & st.healthy
               & (st.iters < cfg.num_iters))
        _, _, frow = _stepped_iter(st.P, st.colsum, upd, ap=st.a, bp=st.b,
                                   fi=fi)
        # Traffic-free lane-health detector (reference ops.py:1373-1387):
        # any NaN/Inf a lane produces passes through its row factors or
        # carried column sums, O(L*(M+N)) values already at hand — the
        # M*N tile is never rescanned. The flag latches False and drops
        # the lane out of ``upd``; other lanes are untouched. Frozen
        # lanes' frow rows are unspecified, so everything read from frow
        # is gated on ``upd``.
        finite = (torch.isfinite(frow).all(dim=-1)
                  & torch.isfinite(st.colsum).all(dim=-1))
        healthy = st.healthy & (finite | ~upd)
        live = upd & healthy
        if cfg.tol is not None:
            drift = lane_factor_drift(frow, st.frow)
            st.converged |= live & (drift <= cfg.tol)
        st.frow = torch.where(live[:, None], frow, st.frow)
        st.iters += upd.to(torch.int32)
        st.healthy = healthy
    return st


# ---- shape-bucketed ragged batching ------------------------------------------

def bucket_shape(M: int, N: int, m_bucket: int = 64,
                 n_bucket: int = 128) -> tuple[int, int]:
    """The padded (M, N) bucket a problem of shape (M, N) lands in."""
    return (M + (-M) % m_bucket, N + (-N) % n_bucket)


def bucket_problems(shapes, m_bucket: int = 64, n_bucket: int = 128):
    """Group problem indices by padded-shape bucket: ``{(Mb, Nb):
    [indices]}`` with insertion order preserved within each bucket."""
    buckets: dict[tuple[int, int], list[int]] = {}
    for idx, (M, N) in enumerate(shapes):
        buckets.setdefault(bucket_shape(M, N, m_bucket, n_bucket),
                           []).append(idx)
    return buckets


# The bucketed path rounds each chunk's batch up to a power of two, as the
# reference does. The reference does it to reuse jit-compiled solves; the
# port compiles nothing per shape, but keeps the rounding and the
# specialization counters so the engine reports the same cache accounting
# (and the same launch plans recur across flushes).
_BUCKETED_STATS = {"hits": 0, "misses": 0}
_BUCKETED_KEYS: set = set()


def bucketed_cache_stats() -> dict:
    """{'hits': ..., 'misses': ...} of bucketed-solve specializations: a
    miss is a (padded shape, canonical batch, dtypes, cfg) combination
    seen for the first time in this process."""
    return dict(_BUCKETED_STATS)


def reset_bucketed_cache_stats() -> None:
    _BUCKETED_STATS.update(hits=0, misses=0)
    _BUCKETED_KEYS.clear()


def canonical_batch(n: int, max_batch: int) -> int:
    """Round a chunk's batch up to the next power of two, capped at
    ``max_batch``; pad slots are all-zero problems (exact no-ops)."""
    B = 1
    while B < n:
        B *= 2
    return min(B, max_batch)


def solve_fused_bucketed(problems, cfg: UOTConfig, *, storage_dtype=None,
                         impl: str | None = None, max_batch: int = 64,
                         m_bucket: int = 64, n_bucket: int = 128,
                         device=None):
    """Solve a ragged list of (A0, a, b) problems via shape-bucketed
    batched solves on ``device`` (default the card).

    Each bucket is zero-padded to its (Mb, Nb) host-side, stacked in
    chunks of at most ``max_batch`` (rounded up to ``canonical_batch``),
    moved to the device in one pinned copy and solved by the streamed
    batched tier — or, with ``impl='auto'`` / ``'resident'`` resolved per
    chunk, by kernel f; the chunk's results come back in one copy.
    Returns a list of (P, colsum) numpy float32 arrays aligned with the
    input order (a bf16 coupling is upcast exactly).
    """
    _check_impl(impl)
    dev = resolve_device(device)
    sdt = _storage(cfg, storage_dtype)
    shapes = [tuple(np.shape(p[0])) for p in problems]
    results: list = [None] * len(problems)
    for (Mb, Nb), idxs in bucket_problems(shapes, m_bucket, n_bucket).items():
        for lo in range(0, len(idxs), max_batch):
            chunk = idxs[lo:lo + max_batch]
            Bpad = canonical_batch(len(chunk), max_batch)
            A = np.zeros((Bpad, Mb, Nb), np.float32)
            a = np.zeros((Bpad, Mb), np.float32)
            b = np.zeros((Bpad, Nb), np.float32)
            for k, i in enumerate(chunk):
                M, N = shapes[i]
                A[k, :M, :N] = np.asarray(problems[i][0], np.float32)
                a[k, :M] = np.asarray(problems[i][1], np.float32)
                b[k, :N] = np.asarray(problems[i][2], np.float32)
            key = (A.shape, str(sdt), str(storage_dtype), impl, cfg)
            if key in _BUCKETED_KEYS:
                _BUCKETED_STATS["hits"] += 1
            else:
                _BUCKETED_KEYS.add(key)
                _BUCKETED_STATS["misses"] += 1
            Ad = to_device(A, dev).to(sdt)
            ad, bd = to_device(a, dev), to_device(b, dev)
            if impl in ("auto", "resident") and _resolve_auto(
                    impl, Mb, Nb, cfg, storage_dtype):
                P, colsum, _, _ = uot_resident.resident_solve(
                    Ad, ad, bd, fi=cfg.fi, num_iters=cfg.num_iters,
                    tol=cfg.tol)
            else:
                P, colsum = _solve_fused_batched_streamed(Ad, ad, bd, cfg)
            P, colsum = _np_f32(to_host(P)), _np_f32(to_host(colsum))
            for k, i in enumerate(chunk):
                M, N = shapes[i]
                results[i] = (P[k, :M, :N].copy(), colsum[k, :N].copy())
    return results
