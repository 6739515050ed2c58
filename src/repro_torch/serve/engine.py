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

``submit_points`` (coordinate payloads) arrives with the geometry slice;
the LLM ``ServeEngine`` with the LLM-substrate slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs as obslib
from repro_torch.core.problem import UOTConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as uot_ops


@dataclasses.dataclass
class UOTRequest:
    rid: int
    K: np.ndarray               # (M, N) initial coupling / Gibbs kernel
    a: np.ndarray               # (M,) row marginal
    b: np.ndarray               # (N,) column marginal

    @property
    def shape(self) -> tuple[int, int]:
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

    def submit_points(self, *args, **kwargs) -> int:
        raise NotImplementedError(uot_ops._GEOMETRY_SLICE)

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

        with uot_ops.dispatch_observer(_observe):
            results = uot_ops.solve_fused_bucketed(
                [(r.K, r.a, r.b) for r in reqs], self.cfg,
                storage_dtype=self.storage_dtype, impl=self.impl,
                max_batch=self.max_batch, m_bucket=self.m_bucket,
                n_bucket=self.n_bucket, device=self.device)
        self.last_dispatch = decisions
        return {r.rid: P for r, (P, _) in zip(reqs, results)}

    @staticmethod
    def cache_stats() -> dict:
        """Process-wide bucketed-solve specialization counters."""
        return uot_ops.bucketed_cache_stats()
