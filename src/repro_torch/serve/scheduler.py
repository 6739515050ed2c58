"""Continuous-batching UOT scheduler: solver lanes as serving slots.

The port of the core of ``repro.serve.scheduler`` (serving tier 3):

* one fixed **lane pool** per (m_bucket, n_bucket) padded-shape bucket — a
  ``kernels.ops.LaneState`` on the card advanced ``chunk_iters``
  Algorithm-1 iterations at a time by ``ops.solve_fused_stepped`` (kernel
  e per iteration, or with ``impl='auto'`` / ``'resident'`` kernel g per
  chunk for pools that fit the resident budget; kernel c at admission).
  Each chunk's ``impl='auto'`` decision is added to the registry counters
  ``serve.dispatch.resident`` / ``serve.dispatch.streamed``;
* between chunks, lanes whose row-factor drift passed ``cfg.tol`` (or that
  hit ``cfg.num_iters``, or went unhealthy) are **evicted** and their
  couplings returned at once;
* queued requests are **admitted** into free lanes earliest-deadline-first
  (ties: higher priority, then FIFO);
* ``submit`` applies **backpressure** (``QueueFullError`` beyond
  ``max_queue`` waiting requests);
* fault containment: typed admission validation, the in-flight lane-health
  detector, quarantine with one log-domain retry (``retried_ok``), and a
  ``poll`` that resolves every rid exactly once;
* ``shed_policy='drop'`` refuses a lane to a request whose deadline passed
  before admission.

Host traffic per round is what the reference moves: the O(L) ``iters`` /
``converged`` / ``healthy`` flags in one read-back, the evicted lanes in
one pinned copy (never the whole pool), and a round's admissions in one
pinned copy per pool.

Not in this slice (each raises ``NotImplementedError``):
``predictive=True``, ``shed_policy='degrade'``, ``brownout``,
``measurements``, ``fault_injector``, non-empty ``slos`` and
``submit_points``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import obs as obslib
from repro_torch.core.health import (InvalidProblemError, escalate_log_solve,
                                     validate_problem)
from repro_torch.core.predict import IterPredictor
from repro_torch.core.problem import UOTConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

# registry counter names ("serve.<name>"): the running totals stats()
# reports, as in the reference
_COUNTER_NAMES = (
    "submitted", "completed", "rejected", "failed", "retried_ok",
    "timed_out", "unhealthy_evictions", "lost_results", "deadline_misses",
    "deadlined_completed", "shed_dropped", "shed_degraded",
    "window_dropped_requests", "window_dropped_occupancy",
    "window_dropped_dispositions")

_OVERLOAD_SLICE = ("arrives with the overload slice of the port (ROADMAP Open "
                   "items 1, item 8)")


class QueueFullError(RuntimeError):
    """Raised by submit() when the waiting queue is at max_queue. Carries
    the observed ``queue_depth``; ``retry_after`` is None until the
    predictive service model is ported."""

    def __init__(self, message: str, *, queue_depth: int | None = None,
                 retry_after: float | None = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.retry_after = retry_after


def submit_with_retry(scheduler, *args, attempts: int = 6,
                      base_delay: float = 0.05, max_delay: float = 2.0,
                      seed: int = 0, sleep: Callable[[float], None] = None,
                      submit: Callable | None = None, **kwargs) -> int:
    """``scheduler.submit(*args, **kwargs)`` with capped exponential
    backoff on ``QueueFullError``: up to ``attempts`` tries, sleeping
    ``min(max_delay, base * 2**i) * (0.5 + 0.5 * jitter)`` between them
    (deterministic jitter from ``seed``; ``base`` is the error's
    ``retry_after`` when it has one). ``sleep`` defaults to the scheduler's
    own injected sleep. The last ``QueueFullError`` propagates;
    ``InvalidProblemError`` is never retried."""
    if sleep is None:
        sleep = getattr(scheduler, "sleep", None) or time.sleep
    fn = submit if submit is not None else scheduler.submit
    rng = np.random.default_rng(seed)
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except QueueFullError as err:
            if attempt == attempts - 1:
                raise
            base = err.retry_after if err.retry_after else base_delay
            delay = min(max_delay, base * (2.0 ** attempt))
            sleep(delay * (0.5 + 0.5 * float(rng.random())))
    raise AssertionError("unreachable")  # pragma: no cover


@dataclasses.dataclass
class RequestFailure:
    """The typed terminal disposition ``poll`` returns when a request did
    not end in a usable coupling: ``status`` is ``'failed'``,
    ``'rejected'`` or ``'lost'``; ``retries`` counts escalations."""

    rid: int
    status: str
    reason: str
    retries: int = 0


@dataclasses.dataclass
class ScheduledRequest:
    """A queued UOT problem plus its scheduling attributes. The payload
    stays host-side numpy while queued and crosses to the card once, at
    admission, already padded to the bucket shape."""

    rid: int
    K: np.ndarray
    a: np.ndarray
    b: np.ndarray
    shape: tuple[int, int]
    bucket: tuple[int, int]
    arrival: float
    deadline: float | None = None
    priority: int = 0
    retries: int = 0

    def edf_key(self):
        """Earliest-deadline-first with priority then FIFO tie-breaks."""
        d = self.deadline if self.deadline is not None else float("inf")
        return (d, -self.priority, self.rid)


@dataclasses.dataclass
class RequestTelemetry:
    """Per-request serving record, filled at eviction."""

    rid: int
    bucket: tuple[int, int]
    lane: int                   # -1 for requests dropped at admission
    arrival: float
    admitted: float
    completed: float
    iters: int
    converged: bool             # False = hit the num_iters cap
    deadline: float | None = None
    shed: str | None = None
    status: str = "ok"          # ok | retried_ok | timed_out | failed |
    retries: int = 0            # rejected
    degrade_level: int = 0
    est_error: float | None = None
    predicted_iters: float | None = None

    @property
    def wait(self) -> float:
        return self.admitted - self.arrival

    @property
    def latency(self) -> float:
        return self.completed - self.arrival

    @property
    def missed(self) -> bool:
        return self.deadline is not None and self.completed > self.deadline


class _LanePool:
    """One shape bucket's lane pool + host-side lane bookkeeping."""

    def __init__(self, bucket: tuple[int, int], num_lanes: int,
                 cfg: UOTConfig, *, storage_dtype=None, device=None):
        self.bucket = bucket
        self.cfg = cfg
        self.state = ops.make_lane_state(
            num_lanes, bucket[0], bucket[1], cfg,
            storage_dtype=storage_dtype, device=device)
        self.requests: dict[int, ScheduledRequest] = {}   # lane -> request
        self.admitted_at: dict[int, float] = {}           # lane -> time
        self.idle_steps = 0
        self._staging: torch.Tensor | None = None
        self._staged: torch.cuda.Event | None = None

    @property
    def num_lanes(self) -> int:
        return self.state.num_lanes

    def stage(self, placed) -> torch.Tensor:
        """A round's admission payloads zero-padded to the bucket shape in
        the pool's host staging buffer — pinned memory on the card, reused
        every round, so each payload is copied once on the host — and sent
        to the pool's device in one copy. Returns the (k, Mb, Nb) fp32
        device tensor."""
        dev = self.state.device
        if self._staging is None:
            self._staging = torch.empty(
                (self.num_lanes,) + self.bucket, dtype=torch.float32,
                pin_memory=dev.type == "cuda")
        if self._staged is not None:
            self._staged.synchronize()     # last round's copy has left
        for j, (_, req) in enumerate(placed):
            M, N = req.shape
            slot = self._staging[j]
            slot[:M, :N].copy_(torch.from_numpy(req.K))
            slot[:M, N:].zero_()
            slot[M:].zero_()
        K = self._staging[:len(placed)]
        if dev.type != "cuda":
            return K.clone()
        K = K.to(dev, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()
        return K

    def free_lanes(self) -> list[int]:
        return [i for i in range(self.num_lanes) if i not in self.requests]

    @property
    def occupancy(self) -> float:
        return len(self.requests) / self.num_lanes


def _host_coupling(P: torch.Tensor, M: int, N: int) -> np.ndarray:
    """A host lane tile trimmed to (M, N) as an owned float32 array (a
    torch copy: it runs on the intra-op threads)."""
    out = torch.empty((M, N), dtype=torch.float32)
    out.copy_(P[:M, :N])
    return out.numpy()


class UOTScheduler:
    """Deadline-aware continuous batching over steppable UOT lane pools on
    ``device`` (default the card; raises without CUDA unless
    ``device='cpu'``).

    Usage::

        sched = UOTScheduler(UOTConfig(num_iters=100, tol=1e-4))
        rid = sched.submit(K, a, b, deadline=now + 0.5, priority=1)
        results = sched.run()          # {rid: coupling}, or step() manually

    Memory is bounded as in the reference: ``poll`` hands a result out
    once, only the most recent ``max_results`` un-polled couplings are
    kept (older ones leave 'lost' tombstones), telemetry keeps ``max_log``
    records, and a pool idle for ``pool_idle_ttl`` rounds is released.
    """

    def __init__(self, cfg: UOTConfig, *, lanes_per_pool: int = 8,
                 chunk_iters: int = 4, max_queue: int = 1024,
                 m_bucket: int = 64, n_bucket: int = 128,
                 storage_dtype=None, impl: str | None = None,
                 max_log: int = 10_000, max_results: int = 256,
                 pool_idle_ttl: int | None = 100,
                 shed_policy: str = "none", validate: bool = True,
                 retry_escalate: bool = True, escalate_factor: int = 2,
                 fault_injector=None, predictive: bool = False,
                 measurements=None, brownout=None,
                 predictor: IterPredictor | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 obs: "obslib.Observability | bool | None" = None,
                 slos=None, device=None):
        if lanes_per_pool < 1:
            raise ValueError("lanes_per_pool must be >= 1")
        if chunk_iters < 1:
            raise ValueError("chunk_iters must be >= 1")
        if shed_policy not in ("none", "drop", "degrade"):
            raise ValueError(f"shed_policy must be 'none', 'drop' or "
                             f"'degrade', got {shed_policy!r}")
        if shed_policy == "degrade":
            raise NotImplementedError("shed_policy='degrade' "
                                      + _OVERLOAD_SLICE)
        if predictive:
            raise NotImplementedError("predictive=True " + _OVERLOAD_SLICE)
        if brownout is not None:
            raise NotImplementedError("brownout " + _OVERLOAD_SLICE)
        if measurements is not None:
            raise NotImplementedError(
                "measurements= arrives with the observability slice of the "
                "port (ROADMAP Open items 1, item 9)")
        if fault_injector is not None:
            raise NotImplementedError(
                "fault_injector= arrives with serve/faults.py in the "
                "containment slice of the port (ROADMAP Open items 1, "
                "item 7)")
        ops._check_impl(impl)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lanes_per_pool = lanes_per_pool
        self.chunk_iters = chunk_iters
        self.max_queue = max_queue
        self.m_bucket = m_bucket
        self.n_bucket = n_bucket
        self.storage_dtype = storage_dtype
        self.impl = impl
        self.max_log = max_log
        self.max_results = max_results
        self.pool_idle_ttl = pool_idle_ttl
        self.shed_policy = shed_policy
        self.validate = validate
        self.retry_escalate = retry_escalate
        self.escalate_factor = escalate_factor
        self.predictor = predictor if predictor is not None else IterPredictor()
        self.clock = clock
        self.sleep = sleep
        if obs is None:
            obs = obslib.Observability(clock=clock)
        elif obs is False:
            obs = obslib.Observability(enabled=False, clock=clock,
                                       chain=False)
        self.obs = obs
        obs.attach_operational(slos=slos or ())
        reg = obs.registry
        self._c = {k: reg.counter("serve." + k) for k in _COUNTER_NAMES}
        self._h_wait = reg.histogram("serve.wait_s")
        self._h_latency = reg.histogram("serve.latency_s")
        self._h_iters = reg.histogram("serve.iters",
                                      buckets=obslib.DEFAULT_COUNT_BUCKETS)
        self._g_queued = reg.gauge("serve.queued")
        self._g_in_flight = reg.gauge("serve.in_flight")
        self._g_occupancy = reg.gauge("serve.occupancy")
        self._c_dispatch = {k: reg.counter("serve.dispatch." + k)
                            for k in ("resident", "streamed")}
        self._c_infeasible = reg.counter("serve.admission.infeasible")
        self._c_degrade = {lvl: reg.counter(f"serve.degrade.l{lvl}")
                           for lvl in (1, 2)}

        self._queue: list[ScheduledRequest] = []
        self._pools: dict[tuple[int, int], _LanePool] = {}
        self._next_rid = 0
        self._results: dict[int, np.ndarray] = {}
        self._dispositions: dict[int, RequestFailure] = {}
        self._steps = 0
        self.request_log: list[RequestTelemetry] = []
        self.occupancy_log: list[dict] = []

    # ---- submission -------------------------------------------------------

    def _reject(self, rid: int, bucket, deadline, err: InvalidProblemError,
                now: float) -> None:
        """Record a refused admission (telemetry + a typed disposition so
        ``poll(rid)`` resolves), then re-raise with the rid attached."""
        self._c["rejected"].inc()
        self._log_request(RequestTelemetry(
            rid=rid, bucket=bucket, lane=-1, arrival=now, admitted=now,
            completed=now, iters=0, converged=False, deadline=deadline,
            status="rejected"))
        self.obs.tracer.emit(rid, "complete", status="rejected",
                             reason=err.reason)
        self._store_disposition(RequestFailure(
            rid=rid, status="rejected", reason=f"{err.reason}: {err}"))
        raise err

    def _store_disposition(self, failure: RequestFailure) -> None:
        self._dispositions[failure.rid] = failure
        while len(self._dispositions) > self.max_log:
            self._dispositions.pop(next(iter(self._dispositions)))
            self._c["window_dropped_dispositions"].inc()

    def _log_request(self, rec: RequestTelemetry) -> None:
        """Append request telemetry and trim to ``max_log`` at once,
        counting what fell off."""
        self.request_log.append(rec)
        excess = len(self.request_log) - self.max_log
        if excess > 0:
            self._c["window_dropped_requests"].inc(excess)
            del self.request_log[:excess]

    def submit(self, K, a, b, *, deadline: float | None = None,
               priority: int = 0) -> int:
        """Enqueue a problem; returns its request id.

        Raises ``QueueFullError`` when ``max_queue`` requests are already
        waiting, and ``InvalidProblemError`` (rid attached, telemetry
        recorded, ``poll(rid)`` resolves to the failure) for problems the
        admission validator refuses.
        """
        if len(self._queue) >= self.max_queue:
            raise QueueFullError(
                f"queue at max_queue={self.max_queue}; retry later",
                queue_depth=len(self._queue))
        K = np.asarray(K)
        a = np.asarray(a)
        b = np.asarray(b)
        rid = self._next_rid
        self._next_rid += 1
        M, N = K.shape
        bucket = ops.bucket_shape(M, N, self.m_bucket, self.n_bucket)
        now = self.clock()
        self._c["submitted"].inc()
        self.obs.tracer.emit(rid, "submit", M=M, N=N, bucket=list(bucket),
                             kind="dense", deadline=deadline,
                             priority=priority)
        if self.validate:
            try:
                validate_problem(self.cfg, a, b, shape=(M, N), rid=rid)
            except InvalidProblemError as err:
                self._reject(rid, bucket, deadline, err, now)
        self._queue.append(ScheduledRequest(
            rid=rid, K=K, a=a, b=b, shape=(M, N), bucket=bucket,
            arrival=now, deadline=deadline, priority=priority))
        self.obs.tracer.emit(rid, "queue", depth=len(self._queue),
                             route="lane")
        return rid

    def submit_points(self, *args, **kwargs) -> int:
        raise NotImplementedError(ops._GEOMETRY_SLICE)

    @property
    def pending(self) -> int:
        """Requests waiting for a lane."""
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        """Requests currently occupying lanes."""
        return sum(len(p.requests) for p in self._pools.values())

    def poll(self, rid: int):
        """The terminal disposition of ``rid``: the finished coupling, a
        ``RequestFailure``, or None while the request is pending. A result
        is handed out exactly once."""
        with self.obs.phases.phase("serve.poll"):
            out = self._results.pop(rid, None)
            if out is not None:
                self.obs.tracer.emit(rid, "poll", resolved="coupling")
                return out
            out = self._dispositions.pop(rid, None)
            self.obs.tracer.emit(
                rid, "poll",
                resolved="failure" if out is not None else "pending")
            return out

    # ---- the scheduling loop ---------------------------------------------

    def step(self) -> dict[int, np.ndarray]:
        """One scheduling round: evict -> admit -> advance one chunk.

        Returns the requests completed by this round, ``{rid: P (M, N)}``
        as host float32 arrays (also retained for ``poll``).
        """
        ph = self.obs.phases
        with ph.phase("serve.evict"):
            completed = self._evict_finished()
        with ph.phase("serve.admit"):
            self._admit_queued()
        with ph.phase("serve.chunk"):
            for bucket, pool in list(self._pools.items()):
                if pool.requests:
                    pool.idle_steps = 0
                    # the chunk's impl='auto' routing goes to the
                    # registry's dispatch counters
                    with ops.dispatch_counters() as counters:
                        ops.solve_fused_stepped(pool.state, self.chunk_iters,
                                                self.cfg, impl=self.impl)
                    for k, v in counters.items():
                        self._c_dispatch[k].inc(v)
                else:
                    pool.idle_steps += 1
                    if (self.pool_idle_ttl is not None
                            and pool.idle_steps > self.pool_idle_ttl):
                        del self._pools[bucket]
        self._steps += 1
        self._snapshot_occupancy()
        return completed

    def run(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Step until queue and lanes drain (or ``max_steps`` more steps
        ran); returns all completions."""
        start = self._steps
        out: dict[int, np.ndarray] = {}
        while self.pending or self.in_flight:
            out.update(self.step())
            if max_steps is not None and self._steps - start >= max_steps:
                break
        out.update(self._evict_finished())  # final chunk's completions
        return out

    # ---- internals --------------------------------------------------------

    def _escalate(self, req: ScheduledRequest):
        """One log-domain retry of a quarantined request; returns
        ``(P or None, iters)``."""
        if not self.retry_escalate or req.retries >= 1:
            return None, 0
        req.retries += 1
        P, stats, ok = escalate_log_solve(
            req.K, req.a, req.b, self.cfg, factor=self.escalate_factor,
            device=self.device)
        return (P if ok else None), stats["iters"]

    def _trim_results(self) -> None:
        while len(self._results) > self.max_results:
            old = next(iter(self._results))
            self._results.pop(old)
            self._c["lost_results"].inc()
            self.obs.tracer.emit(old, "lost")
            self._store_disposition(RequestFailure(
                rid=old, status="lost",
                reason="coupling evicted from the bounded result store "
                       "(max_results) before it was polled"))

    def _read_flags(self, pool: _LanePool):
        """The pool's O(L) iters / converged / healthy in one read-back."""
        st = pool.state
        flags = ops.to_host(torch.stack([
            st.iters, st.converged.to(torch.int32),
            st.healthy.to(torch.int32)])).numpy()
        return flags[0], flags[1].astype(bool), flags[2].astype(bool)

    def _fetch_lanes(self, pool: _LanePool, lanes: list[int]):
        """The evicted lanes' tiles in one pinned copy, plus a per-lane
        all-finite flag computed on the device."""
        if not lanes:
            return None, None
        idx = torch.as_tensor(lanes, dtype=torch.long).to(self.device)
        P = pool.state.P.index_select(0, idx)
        finite = torch.isfinite(P).flatten(1).all(dim=1)
        return ops.to_host(P), ops.to_host(finite).numpy()

    def _evict_finished(self) -> dict[int, np.ndarray]:
        completed: dict[int, np.ndarray] = {}
        now = self.clock()
        tr = self.obs.tracer
        for pool in self._pools.values():
            if not pool.requests:
                continue
            iters, conv, healthy = self._read_flags(pool)
            if tr.enabled:
                for l, req in pool.requests.items():
                    tr.emit(req.rid, "chunk", lane=l, device=-1,
                            iters=int(iters[l]), converged=bool(conv[l]),
                            healthy=bool(healthy[l]))
            finished = [l for l in pool.requests
                        if not healthy[l] or conv[l]
                        or iters[l] >= self.cfg.num_iters]
            if not finished:
                continue
            sound = [l for l in finished if healthy[l]]
            tiles, finite = self._fetch_lanes(pool, sound)
            for lane in finished:
                req = pool.requests.pop(lane)
                admitted = pool.admitted_at.pop(lane)
                M, N = req.shape
                P = None
                if healthy[lane]:
                    j = sound.index(lane)
                    # second line of defense: poison that landed after the
                    # convergence latch froze the lane
                    if finite[j]:
                        P = _host_coupling(tiles[j], M, N)
                n_iters = int(iters[lane])
                tr.emit(req.rid, "evict", lane=lane, device=-1,
                        iters=n_iters, converged=bool(conv[lane]),
                        healthy=bool(healthy[lane] and P is not None))
                if P is not None:
                    timed_out = self.cfg.tol is not None and not conv[lane]
                    status = "timed_out" if timed_out else "ok"
                    self._c["timed_out"].inc(int(timed_out))
                else:
                    self._c["unhealthy_evictions"].inc()
                    tr.emit(req.rid, "escalate", retries=req.retries + 1)
                    P, n_iters = self._escalate(req)
                    status = "retried_ok" if P is not None else "failed"
                if P is not None:
                    if status == "retried_ok":
                        self._c["retried_ok"].inc()
                    completed[req.rid] = self._results[req.rid] = P
                    self._trim_results()
                else:
                    self._c["failed"].inc()
                    self._store_disposition(RequestFailure(
                        rid=req.rid, status="failed",
                        reason="lane state went non-finite and the "
                               "log-domain escalation did not recover",
                        retries=req.retries))
                rec = RequestTelemetry(
                    rid=req.rid, bucket=pool.bucket, lane=lane,
                    arrival=req.arrival, admitted=admitted,
                    completed=now, iters=n_iters,
                    converged=bool(conv[lane] & healthy[lane]),
                    deadline=req.deadline, status=status, retries=req.retries)
                if rec.deadline is not None:
                    self._c["deadlined_completed"].inc()
                    self._c["deadline_misses"].inc(int(rec.missed))
                self._c["completed"].inc()
                self._h_wait.observe(rec.wait)
                self._h_latency.observe(rec.latency)
                self._h_iters.observe(n_iters)
                tr.emit(req.rid, "complete", status=status, iters=n_iters,
                        retries=req.retries)
                self._log_request(rec)
            # one pool update for the round's evictions; zeroing also
            # scrubs a poisoned lane's NaNs out of the pool
            ops.lane_evict(pool.state, finished)
        return completed

    def inject_lane_fault(self, rid: int) -> bool:
        """Drill hook: poison the in-flight lane holding ``rid`` with NaN
        state (tile, column sums, factors), simulating device-memory
        corruption mid-solve; the host payload stays intact so the
        quarantine-and-retry path can recover it. Returns False when the
        rid is not in a lane. Never called by the serving loop itself."""
        for pool in self._pools.values():
            for lane, req in pool.requests.items():
                if req.rid == rid:
                    st = pool.state
                    st.P[lane] = float("nan")
                    st.colsum[lane] = float("nan")
                    st.frow[lane] = float("nan")
                    return True
        return False

    def _shed_at_admission(self, req: ScheduledRequest, now: float) -> bool:
        """``shed_policy='drop'``: refuse a lane to a request whose deadline
        already passed; returns True when the request was dropped."""
        if (self.shed_policy == "none" or req.deadline is None
                or now <= req.deadline):
            return False
        self._c["shed_dropped"].inc()
        self._c["rejected"].inc()
        self._log_request(RequestTelemetry(
            rid=req.rid, bucket=req.bucket, lane=-1,
            arrival=req.arrival, admitted=now, completed=now,
            iters=0, converged=False, deadline=req.deadline,
            shed="dropped", status="rejected"))
        self.obs.tracer.emit(req.rid, "shed", policy="drop")
        self.obs.tracer.emit(req.rid, "complete", status="rejected",
                             reason="deadline passed at admission "
                                    "(shed_policy='drop')")
        self._store_disposition(RequestFailure(
            rid=req.rid, status="rejected",
            reason="deadline already passed at admission "
                   "(shed_policy='drop')"))
        return True

    def _admit_queued(self) -> None:
        if not self._queue:
            return
        now = self.clock()
        remaining: list[ScheduledRequest] = []
        placements: dict[tuple[int, int],
                         list[tuple[int, ScheduledRequest]]] = {}
        for req in sorted(self._queue, key=ScheduledRequest.edf_key):
            if self._shed_at_admission(req, now):
                continue
            pool = self._pools.get(req.bucket)
            if pool is None:
                pool = self._pools[req.bucket] = _LanePool(
                    req.bucket, self.lanes_per_pool, self.cfg,
                    storage_dtype=self.storage_dtype, device=self.device)
            free = pool.free_lanes()
            if not free:
                remaining.append(req)
                continue
            lane = free[0]
            placements.setdefault(req.bucket, []).append((lane, req))
            pool.requests[lane] = req
            pool.admitted_at[lane] = now
            self.obs.tracer.emit(req.rid, "place", lane=lane, device=-1,
                                 bucket=list(req.bucket), route="lane")
        for bucket, placed in placements.items():
            self._admit_dense(bucket, placed)
        self._queue = remaining

    def _admit_dense(self, bucket, placed) -> None:
        """Pad a round's admissions to the bucket shape host-side and land
        them in the pool with one pinned copy and one pool update."""
        pool = self._pools[bucket]
        Mb, Nb = bucket
        k = len(placed)
        ap = np.zeros((k, Mb), np.float32)
        bp = np.zeros((k, Nb), np.float32)
        for j, (_, req) in enumerate(placed):
            M, N = req.shape
            ap[j, :M] = req.a
            bp[j, :N] = req.b
        dev = self.device
        ops.lane_admit(pool.state, [lane for lane, _ in placed],
                       pool.stage(placed), ops.to_device(ap, dev),
                       ops.to_device(bp, dev))

    def _snapshot_occupancy(self) -> None:
        occ = {str(b): p.occupancy for b, p in self._pools.items()}
        self.occupancy_log.append({
            "step": self._steps,
            "queued": len(self._queue),
            "deadline_misses": self._c["deadline_misses"].value,
            "pools": occ,
        })
        self._g_queued.set(len(self._queue))
        self._g_in_flight.set(self.in_flight)
        self._g_occupancy.set(sum(occ.values()) / len(occ) if occ else 0.0)
        self._c["window_dropped_occupancy"].inc(
            max(0, len(self.occupancy_log) - self.max_log))
        del self.occupancy_log[:-self.max_log]

    # ---- telemetry --------------------------------------------------------

    def stats(self) -> dict:
        """Aggregate serving telemetry over the retained log window, with
        the running totals read from the ``serve.*`` registry counters (the
        reference's keys; the overload-model entries stay zero / None
        until that slice is ported)."""
        c = self._c
        misses = {
            "deadline_misses": c["deadline_misses"].value,
            "miss_rate": (c["deadline_misses"].value
                          / c["deadlined_completed"].value
                          if c["deadlined_completed"].value else 0.0),
            "shed_dropped": c["shed_dropped"].value,
            "shed_degraded": c["shed_degraded"].value,
            "rejected": c["rejected"].value,
            "failed": c["failed"].value,
            "retried_ok": c["retried_ok"].value,
            "timed_out": c["timed_out"].value,
            "unhealthy_evictions": c["unhealthy_evictions"].value,
            "lost_results": c["lost_results"].value,
            "window_dropped": {
                "requests": c["window_dropped_requests"].value,
                "occupancy": c["window_dropped_occupancy"].value,
                "dispositions": c["window_dropped_dispositions"].value,
            },
            "admission_infeasible": self._c_infeasible.value,
            "degrade_levels": {lvl: ctr.value
                               for lvl, ctr in self._c_degrade.items()},
            "brownout_level": 0,
            "seconds_per_iter": None,
        }
        status_counts: dict[str, int] = {}
        for t in self.request_log:
            status_counts[t.status] = status_counts.get(t.status, 0) + 1
        misses["status_counts"] = status_counts
        served = [t for t in self.request_log
                  if t.shed != "dropped" and t.status != "rejected"]
        if not served:
            return {"completed": 0, "steps": self._steps, "wait_mean": 0.0,
                    "wait_p99": 0.0, "latency_p50": 0.0, "latency_p99": 0.0,
                    "iters_mean": 0.0, "iters_max": 0,
                    "converged_frac": 0.0, "occupancy_mean": 0.0, **misses}
        waits = np.array([t.wait for t in served])
        lats = np.array([t.latency for t in served])
        iters = np.array([t.iters for t in served])
        occ = [o for snap in self.occupancy_log
               for o in snap["pools"].values()]
        return {
            "completed": len(served),
            "steps": self._steps,
            "wait_mean": float(waits.mean()),
            "wait_p99": float(np.percentile(waits, 99)),
            "latency_p50": float(np.percentile(lats, 50)),
            "latency_p99": float(np.percentile(lats, 99)),
            "iters_mean": float(iters.mean()),
            "iters_max": int(iters.max()),
            "converged_frac": float(np.mean([t.converged for t in served])),
            "occupancy_mean": float(np.mean(occ)) if occ else 0.0,
            **misses,
        }
