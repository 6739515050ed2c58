"""Public solver entry points over the batched kernels (c, d, e).

The port of the batched, bucketed and stepped subset of
``repro.kernels.ops``:

* ``solve_fused_batched`` — a stack of same-shape problems, one kernel
  launch per iteration for the whole stack (kernel c for the initial
  column sums, kernel d per iteration; kernel e per iteration when
  ``cfg.tol`` freezes lanes one by one);
* ``solve_fused_bucketed`` — a ragged problem list grouped into
  padded-shape buckets, each solved by ``solve_fused_batched``;
* ``LaneState`` + ``lane_admit`` / ``lane_evict`` / ``lane_done`` +
  ``solve_fused_stepped`` — the steppable lane pool the serving
  scheduler advances a chunk of iterations at a time (kernel e, plus
  kernel c for an admitted lane's initial column sums).

Entry points run on the card unless the caller asks for the CPU
(``device=`` on ``solve_fused_batched``, ``solve_fused_bucketed`` and
``make_lane_state``; a pool's functions follow the pool). Without CUDA the
default raises. On a CPU device every kernel wrapper takes its plain
PyTorch version, which is how the tests run the port against the JAX
reference.

What differs from the reference, by design:

* **In place.** The fused passes overwrite the coupling, and the lane
  functions (``lane_admit``, ``lane_evict``, ``solve_fused_stepped``)
  update the pool's tensors in place and return the same ``LaneState``.
* **No alignment padding.** The CUDA kernels mask ragged edges, so
  ``make_lane_state(L, M, N)`` holds exactly (L, M, N) and
  ``solve_fused_batched`` pads nothing. ``bucket_shape``'s ``m_bucket`` /
  ``n_bucket`` keep their meaning (they decide which problems share a
  pool); the TPU's (8, 128) tiling and 32 MiB VMEM budget have no
  counterpart here — ``pick_block_m`` is Hopper's (shared memory per
  block, see ``uot_batched.plan_for``).
* **Host traffic.** Payloads cross to the card through pinned memory in
  one copy per batch; results come back the same way.

``impl`` takes None or ``'kernel'`` (both mean the kernels above).
``'auto'`` / ``'resident'`` (the whole-solve resident tier, kernels f, g)
and ``geometry=`` (kernels h-k) raise ``NotImplementedError`` until their
slices land.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.convergence import lane_factor_drift
from repro_torch.core.problem import UOTConfig, rescale_factors
from repro_torch.device import resolve_device
from repro_torch.kernels import uot_batched
from repro_torch.kernels.uot_batched import pick_block_m

__all__ = [
    "pad_to", "pad_vec", "pick_block_m", "solve_fused_batched",
    "solve_fused_bucketed", "bucket_shape", "bucket_problems",
    "canonical_batch", "bucketed_cache_stats", "reset_bucketed_cache_stats",
    "LaneState", "make_lane_state", "lane_admit", "lane_evict", "lane_done",
    "solve_fused_stepped", "to_device", "to_host",
]

_RESIDENT_SLICE = ("the resident tier (impl='auto'/'resident', kernels f "
                   "and g) arrives with the resident slice of the port "
                   "(ROADMAP Open items 1, item 5)")
_GEOMETRY_SLICE = ("cost geometries (geometry=, kernels h-k) arrive with the "
                   "geometry slice of the port (ROADMAP Open items 1, item 6)")
# how often the tol batched solve reads back "all lanes converged"
_CONV_CHECK_EVERY = 4


def _check_impl(impl) -> None:
    if impl in ("auto", "resident"):
        raise NotImplementedError(_RESIDENT_SLICE)
    if impl not in (None, "kernel"):
        raise ValueError(f"impl must be None or 'kernel', got {impl!r}")


def _storage(cfg: UOTConfig, storage_dtype) -> torch.dtype:
    sdt = storage_dtype if storage_dtype is not None else cfg.dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"storage dtype must be torch.float32 or "
                        f"torch.bfloat16, got {sdt}")
    return sdt


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
    back every few iterations) or ``num_iters`` is hit.
    """
    if geometry is not None:
        raise NotImplementedError(_GEOMETRY_SLICE)
    _check_impl(impl)
    dev = resolve_device(device)
    sdt = _storage(cfg, storage_dtype)
    A = to_device(A0, dev).to(sdt)
    a = to_device(a, dev).float()
    b = to_device(b, dev).float()
    return _solve_fused_batched_streamed(A, a, b, cfg)


def _solve_fused_batched_streamed(A, a, b, cfg: UOTConfig):
    fi = cfg.fi
    colsum = uot_batched.batched_colsum(A)
    if cfg.tol is None:
        for _ in range(cfg.num_iters):
            A, colsum, _ = _stepped_iter(A, colsum, None, ap=a, bp=b, fi=fi)
        return A, colsum
    B = A.shape[0]
    prev_frow = torch.ones_like(a)
    conv = torch.zeros(B, dtype=torch.bool, device=A.device)
    for i in range(cfg.num_iters):
        if i % _CONV_CHECK_EVERY == 0 and bool(conv.all()):
            break
        upd = ~conv
        A, colsum, frow = _stepped_iter(A, colsum, upd, ap=a, bp=b, fi=fi)
        drift = lane_factor_drift(frow, prev_frow)
        prev_frow = torch.where(upd[:, None], frow, prev_frow)
        conv = conv | (upd & (drift <= cfg.tol))
    return A, colsum


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
    what shares the pool. Nothing is read back to the host.
    """
    _check_impl(impl)
    return _solve_fused_stepped_streamed(state, n_iters, cfg)


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
    moved to the device in one pinned copy and solved by
    ``solve_fused_batched``; the chunk's results come back in one copy.
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
            P, colsum = _solve_fused_batched_streamed(
                to_device(A, dev).to(sdt), to_device(a, dev),
                to_device(b, dev), cfg)
            P, colsum = _np_f32(to_host(P)), _np_f32(to_host(colsum))
            for k, i in enumerate(chunk):
                M, N = shapes[i]
                results[i] = (P[k, :M, :N].copy(), colsum[k, :N].copy())
    return results
