"""Flush-barrier UOT request batching (serving tier 2), PyTorch port.

The port of ``repro.serve.engine``'s ``UOTRequest`` / ``UOTBatchEngine``.
Clients submit independent (K, a, b) problems of any shape; ``flush()``
groups the queue into padded-shape buckets and solves each bucket chunk
with one batched solve on the card (``ops.solve_fused_bucketed``: kernel c
once, kernel d — or e under ``cfg.tol`` — per iteration for the whole
chunk; with ``impl='auto'`` a bucket that fits the resident budget is one
launch of kernel f, and each flush's decisions are recorded in
``last_dispatch`` through ``ops.dispatch_observer``). Zero-padding inside
a bucket is exact, so every response equals its standalone solve. The
flush is a barrier: for latency-sensitive traffic use ``UOTScheduler``.

``submit_points`` enqueues a point-cloud problem (``C = ||x - y||^2 /
scale``): the request carries ``(M + N) * (d + 1)`` floats instead of an
``M * N`` matrix, and the flush solves each (bucket, d, scale) group with
``ops.solve_fused_batched(geometry=...)``, whose kernels compute the Gibbs
tiles on the card (h, i, then d / e; k where ``impl='auto'`` routes
resident). A point request's coupling equals dense submission of
``geometry.kernel(cfg.reg)``, bit for bit. The LLM ``ServeEngine`` comes
with the LLM-substrate slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs as obslib
from repro_torch.core.problem import UOTConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as uot_ops
from repro_torch.serve.points import point_payload, stage_points


@dataclasses.dataclass
class UOTRequest:
    rid: int
    K: np.ndarray | None        # (M, N) initial coupling / Gibbs kernel
    a: np.ndarray               # (M,) row marginal
    b: np.ndarray               # (N,) column marginal
    # coordinate payload (set iff K is None): a point-cloud request
    x: np.ndarray | None = None     # (M, d)
    y: np.ndarray | None = None     # (N, d)
    xn: np.ndarray | None = None    # (M,) squared norms, computed once
    yn: np.ndarray | None = None    # (N,)
    scale: float = 1.0

    @property
    def shape(self) -> tuple[int, int]:
        if self.K is None:
            return (self.x.shape[0], self.y.shape[0])
        return tuple(self.K.shape)


class UOTBatchEngine:
    """Shape-bucketed batch solving of queued UOT requests on ``device``
    (default the card; raises without CUDA unless ``device='cpu'``).

    ``submit()`` enqueues a problem and returns a request id; ``flush()``
    drains the queue with one batched solve per (bucket, ``max_batch``
    chunk) and returns {rid: coupling (M, N) numpy float32}.
    ``storage_dtype=torch.bfloat16`` keeps the coupling in bf16 on the
    card (fp32 accumulation) for half the bytes per iteration.
    """

    def __init__(self, cfg: UOTConfig, *, max_batch: int = 64,
                 m_bucket: int = 64, n_bucket: int = 128,
                 storage_dtype=None, impl: str | None = None,
                 obs: "obslib.Observability | bool | None" = None,
                 device=None):
        uot_ops._check_impl(impl)
        self.cfg = cfg
        self.max_batch = max_batch
        self.m_bucket = m_bucket
        self.n_bucket = n_bucket
        self.storage_dtype = storage_dtype
        self.impl = impl
        self.device = resolve_device(device)
        if obs is None:
            obs = obslib.Observability()
        elif obs is False:
            obs = obslib.Observability(enabled=False, chain=False)
        self.obs = obs
        reg = obs.registry
        self._c_submitted = reg.counter("engine.submitted")
        self._c_flushes = reg.counter("engine.flushes")
        self._c_flushed = reg.counter("engine.flushed")
        self._queue: list[UOTRequest] = []
        self._next_rid = 0
        # {(Mb, Nb): 'resident' | 'streamed'}: the impl='auto' routing of
        # the last flush's buckets, as dispatch made it (empty for an
        # explicit impl, which makes no decision)
        self.last_dispatch: dict[tuple[int, int], str] = {}

    def submit(self, K, a, b) -> int:
        # payloads stay host-side numpy until flush() assembles the padded
        # batch — one device transfer per bucket chunk
        rid = self._next_rid
        self._next_rid += 1
        self._c_submitted.inc()
        self._queue.append(UOTRequest(rid, np.asarray(K), np.asarray(a),
                                      np.asarray(b)))
        return rid

    def submit_points(self, x, y, a, b, *, scale: float = 1.0) -> int:
        """Enqueue a point-cloud problem, the squared-Euclidean cost of the
        (M, d) / (N, d) clouds ``C = ||x - y||^2 / scale``. The payload
        stays host-side: ``(M + N) * (d + 1)`` floats instead of the
        ``M * N`` kernel."""
        x, y, xn, yn = point_payload(x, y)
        rid = self._next_rid
        self._next_rid += 1
        self._c_submitted.inc()
        self._queue.append(UOTRequest(rid, None, np.asarray(a),
                                      np.asarray(b), x=x, y=y, xn=xn, yn=yn,
                                      scale=float(scale)))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue)

    def flush(self) -> dict[int, np.ndarray]:
        """Solve every queued request; returns {rid: coupling (M, N)}."""
        reqs, self._queue = self._queue, []
        if not reqs:
            return {}
        self._c_flushes.inc()
        self._c_flushed.inc(len(reqs))
        decisions: dict[tuple[int, int], str] = {}

        def _observe(kind, *, M, N, itemsize, num_iters):
            decisions[(M, N)] = kind

        dense = [r for r in reqs if r.K is not None]
        points = [r for r in reqs if r.K is None]
        out: dict[int, np.ndarray] = {}
        with uot_ops.dispatch_observer(_observe):
            if dense:
                results = uot_ops.solve_fused_bucketed(
                    [(r.K, r.a, r.b) for r in dense], self.cfg,
                    storage_dtype=self.storage_dtype, impl=self.impl,
                    max_batch=self.max_batch, m_bucket=self.m_bucket,
                    n_bucket=self.n_bucket, device=self.device)
                out.update({r.rid: P for r, (P, _) in zip(dense, results)})
            if points:
                out.update(self._flush_points(points))
        self.last_dispatch = decisions
        return {r.rid: out[r.rid] for r in reqs}

    def _flush_points(self, reqs) -> dict[int, np.ndarray]:
        """Bucketed batch solving of point requests: the chunking of
        ``ops.solve_fused_bucketed`` (padded-shape buckets, chunks of
        ``max_batch`` rounded up by ``canonical_batch``), grouped also by
        (d, scale), each chunk's coordinates staged in one pinned copy
        (``stage_points``) and solved by ``solve_fused_batched`` with the
        batched geometry. Zero-padding is exact through the kernels'
        valid-count masks."""
        groups: dict[tuple, list[UOTRequest]] = {}
        for r in reqs:
            bucket = uot_ops.bucket_shape(*r.shape, self.m_bucket,
                                          self.n_bucket)
            groups.setdefault((bucket, r.x.shape[1], r.scale), []).append(r)
        results: dict[int, np.ndarray] = {}
        for ((Mb, Nb), _, scale), members in groups.items():
            for lo in range(0, len(members), self.max_batch):
                chunk = members[lo:lo + self.max_batch]
                Bpad = uot_ops.canonical_batch(len(chunk), self.max_batch)
                geom, a, b = stage_points(chunk, Bpad, Mb, Nb, scale,
                                          self.device)
                P, _ = uot_ops.solve_fused_batched(
                    None, a, b, self.cfg, storage_dtype=self.storage_dtype,
                    impl=self.impl, geometry=geom, device=self.device)
                P = uot_ops._np_f32(uot_ops.to_host(P))
                for k, r in enumerate(chunk):
                    M, N = r.shape
                    results[r.rid] = P[k, :M, :N].copy()
        return results

    @staticmethod
    def cache_stats() -> dict:
        """Process-wide bucketed-solve specialization counters."""
        return uot_ops.bucketed_cache_stats()
