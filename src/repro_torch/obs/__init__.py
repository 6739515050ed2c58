"""Observability for the port: metrics registry, span tracer, phase timer.

The port of ``repro.obs`` as far as serving needs it in this slice.
``registry``, ``trace`` and ``profile`` are copies of the reference's
host-only modules. ``Observability`` bundles the registry, the tracer
and the phase timer under the reference's attribute names; the members
of later slices — the traffic accountant, kernel profiler, rolling
windows, SLO monitor, flight recorder and exporter — are null twins
until the observability slice ports them, and
``attach_operational`` with objectives raises ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Callable

from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, DEFAULT_COUNT_BUCKETS,
                                      DEFAULT_TIME_BUCKETS, geometric_buckets,
                                      percentile_from_state)
from repro_torch.obs.trace import NullTracer, SpanTracer, TERMINAL_STATUSES
from repro_torch.obs.profile import (NullKernelProfiler, NullPhaseTimer,
                                     PhaseTimer)

__all__ = [
    "Observability", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "SpanTracer", "NullTracer", "PhaseTimer", "NullPhaseTimer",
    "NullKernelProfiler", "TERMINAL_STATUSES",
    "DEFAULT_TIME_BUCKETS", "DEFAULT_COUNT_BUCKETS", "geometric_buckets",
    "percentile_from_state", "get_global", "reset_global", "global_dump",
]

_OPERATIONAL_SLICE = ("SLO objectives (the operational plane: windows, SLO "
                      "monitor, flight recorder, exporters) arrive with the "
                      "observability slice of the port (ROADMAP Open items "
                      "1, item 9)")


class _Null:
    """Null twin of a later-slice instrument: ``enabled`` is False and
    every method is a no-op returning None."""

    enabled = False

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Observability:
    """One scheduler's instrument bundle.

    ``enabled=False`` keeps the registry live (``stats()`` reads its
    counters) but swaps the tracer and phase timer for no-ops. ``parent``
    defaults to the process-global bundle (``chain=False`` isolates).
    """

    def __init__(self, *, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 chain: bool = True,
                 parent: "Observability | None" = None):
        if parent is None and chain:
            parent = get_global()
        self.enabled = enabled
        self.parent = parent
        self.clock = clock
        self.registry = MetricsRegistry(
            parent=parent.registry if parent is not None else None)
        self.traffic = _Null()
        self.windows = _Null()
        self.slo = _Null()
        self.flight = _Null()
        self.exporter = _Null()
        self.profile = NullKernelProfiler()
        if enabled:
            self.tracer = SpanTracer(clock=clock)
            self.phases = PhaseTimer(self.registry)
        else:
            self.tracer = NullTracer(clock=clock)
            self.phases = NullPhaseTimer()

    def attach_operational(self, *, slos=(), **_ignored) -> "Observability":
        """No-op until the operational plane is ported; raises for a
        non-empty ``slos``."""
        if slos:
            raise NotImplementedError(_OPERATIONAL_SLICE)
        return self

    def dump(self) -> dict:
        """Registry snapshot (spans export via ``tracer.write_jsonl``)."""
        return {"enabled": self.enabled, "registry": self.registry.dump()}


class _GlobalObservability(Observability):
    """The process-global aggregation root."""

    def __init__(self):
        super().__init__(enabled=True, chain=False, parent=None)

    def reset(self) -> None:
        self.registry.reset()
        self.tracer.clear()


_GLOBAL: _GlobalObservability | None = None


def get_global() -> _GlobalObservability:
    """The process-global ``Observability`` (created on first use)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = _GlobalObservability()
    return _GLOBAL


def reset_global() -> None:
    get_global().reset()


def global_dump() -> dict:
    return get_global().dump()
