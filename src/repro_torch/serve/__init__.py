"""UOT serving on the card (PyTorch port of ``repro.serve``, tiers 2-3).

Tier 2 — bucketed flush (``UOTBatchEngine``): queue requests, then
  ``flush()`` solves each padded-shape bucket in one batched solve. Every
  request in a flush waits for the slowest problem of its bucket.

Tier 3 — continuous scheduler (``UOTScheduler``): fixed lane pools advance
  chunk by chunk; finished lanes are evicted and returned at once, freed
  lanes are refilled earliest-deadline-first, ``submit`` applies
  backpressure, and poisoned lanes are quarantined and retried once on the
  log-domain tier.

Tier 1 (``ops.solve_fused``, kernels a and b) and tier 4 (the cluster
scheduler) arrive with later slices of the port.
"""
from repro_torch.serve.engine import UOTBatchEngine, UOTRequest
from repro_torch.serve.scheduler import (QueueFullError, RequestFailure,
                                         RequestTelemetry, ScheduledRequest,
                                         UOTScheduler, submit_with_retry)

__all__ = ["UOTBatchEngine", "UOTRequest", "QueueFullError",
           "RequestFailure", "RequestTelemetry", "ScheduledRequest",
           "UOTScheduler", "submit_with_retry"]
