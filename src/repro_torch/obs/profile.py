"""Wall-clock profiler: scheduler round phases + kernel-launch timing.

The measured half of the observability story. ``repro.obs.traffic``
charges *modeled* bytes per dispatch decision; this module records the
*measured* host wall-clock next to them, so achieved GB/s per kernel
cell (``repro.obs.measure``) and an honest roofline fraction can sit
beside the modeled ones.

Two instruments, both feeding ``profile.*`` registry histograms:

* ``PhaseTimer`` — scoped timers for the scheduler round phases
  (admission prep / device chunk / eviction / poll, in both the
  ``serve`` and ``cluster`` step loops). Phases nest: each phase records
  its **total** wall time under ``profile.phase.<name>`` and its
  **exclusive** time (total minus enclosed child phases) under
  ``profile.phase.<name>.self``, so a round's breakdown sums correctly
  even when one phase wraps another.
* ``KernelProfiler`` — per-launch timing of every dispatched solve /
  chunk, keyed by the **measurement cell**
  ``(kernel, MxN shape, storage itemsize, impl tier, cost source,
  lanes, iteration budget)`` — the same parameters the traffic
  accountant's formulas take, so a cell's measured seconds divide its
  modeled bytes with no joins. The *first* observation of a cell is the
  trace+compile call and is recorded separately
  (``profile.compile.<cell>``) from steady-state execute
  (``profile.kernel.<cell>``); steady-state samples are additionally
  kept in a small bounded deque for exact medians (histograms give
  bucket-interpolated percentiles only). ``kernels/ops.py`` installs
  the hook via ``ops.launch_profiler(profiler)`` — the launch-timing
  twin of ``ops.dispatch_observer`` — and forces a device sync per
  profiled launch, which is why the null twins exist: under
  ``obs=False`` nothing is installed and no sync happens.

Clocks: phase/launch timing uses ``time.perf_counter`` by default even
when the owning scheduler runs on a simulated clock — kernel cost is a
host wall-clock fact, not a DES fact. Tests inject a fake ``clock=``.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable

__all__ = ["PhaseTimer", "NullPhaseTimer", "KernelProfiler",
           "NullKernelProfiler", "cell_key", "parse_cell_key"]


def cell_key(kernel: str, M: int, N: int, itemsize: int, impl: str,
             source: str = "dense", lanes: int = 1, iters: int = 1) -> str:
    """Canonical string key of one measurement cell (JSON-able, stable)."""
    return (f"{kernel}|{M}x{N}|s{itemsize}|{impl}|{source}"
            f"|L{lanes}|T{iters}")


def parse_cell_key(key: str) -> dict:
    """Inverse of ``cell_key`` — the formula parameters as a dict."""
    kernel, shape, s, impl, source, lanes, iters = key.split("|")
    M, N = shape.split("x")
    return {"kernel": kernel, "M": int(M), "N": int(N),
            "itemsize": int(s[1:]), "impl": impl, "source": source,
            "lanes": int(lanes[1:]), "iters": int(iters[1:])}


class PhaseTimer:
    """Scoped wall-clock timers for named phases, nesting-aware.

    ``with phases.phase("serve.chunk"): ...`` observes the elapsed
    seconds into ``profile.phase.serve.chunk`` and the exclusive
    (children-subtracted) seconds into ``...serve.chunk.self``. The
    phase stack is thread-local: concurrent step loops in different
    threads do not see each other's frames.
    """

    enabled = True

    def __init__(self, registry, *, prefix: str = "profile.phase",
                 clock: Callable[[], float] = time.perf_counter):
        self.registry = registry
        self.prefix = prefix
        self.clock = clock
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def phase(self, name: str):
        stack = self._stack()
        frame = [self.clock(), 0.0]   # [start, accumulated child total]
        stack.append(frame)
        try:
            yield
        finally:
            stack.pop()
            total = self.clock() - frame[0]
            if stack:
                stack[-1][1] += total
            self.registry.histogram(f"{self.prefix}.{name}").observe(total)
            self.registry.histogram(
                f"{self.prefix}.{name}.self").observe(total - frame[1])


class NullPhaseTimer:
    """``obs=False`` twin: ``phase()`` is a free nullcontext."""

    enabled = False

    def __init__(self, *_, **__):
        pass

    def phase(self, name: str):
        return contextlib.nullcontext()


class _Cell:
    __slots__ = ("count", "first_s", "samples")

    def __init__(self, keep: int):
        self.count = 0
        self.first_s: float | None = None
        self.samples: collections.deque = collections.deque(maxlen=keep)


class KernelProfiler:
    """Per-cell launch timing: first-call apart from steady-state.

    ``observe_launch`` is the sink ``ops.launch_profiler`` feeds (ops
    does the ``block_until_ready`` timing; this object only ingests
    seconds). The first observation of a cell is the trace+compile call
    — its time goes to ``profile.compile.<cell>`` and is excluded from
    the steady-state deque, so ``median_us`` never includes compile.
    """

    enabled = True

    def __init__(self, registry=None, *, keep: int = 128, parent=None):
        self.registry = registry
        self.keep = keep
        self.parent = parent
        self._lock = threading.Lock()
        self._cells: dict[str, _Cell] = {}

    def _record(self, key: str, seconds: float) -> bool:
        """Cell bookkeeping only; returns whether this was the cell's
        first (trace+compile) observation."""
        with self._lock:
            cell = self._cells.get(key)
            first = cell is None
            if first:
                cell = self._cells[key] = _Cell(self.keep)
                cell.first_s = float(seconds)
            else:
                cell.samples.append(float(seconds))
            cell.count += 1
        return first

    def observe_launch(self, *, kernel: str, M: int, N: int, itemsize: int,
                       impl: str, source: str = "dense", lanes: int = 1,
                       iters: int = 1, seconds: float) -> None:
        key = cell_key(kernel, M, N, itemsize, impl, source, lanes, iters)
        first = self._record(key, seconds)
        if self.registry is not None:
            name = ("profile.compile." if first else "profile.kernel.")
            self.registry.histogram(name + key).observe(seconds)
        # parent chain mirrors the registry's rollup, cells-only: the
        # histogram observation above already propagates through the
        # parent-chained registry, so ancestors get _record alone
        p = self.parent
        while p is not None:
            p._record(key, seconds)
            p = getattr(p, "parent", None)

    # -- readback ---------------------------------------------------------
    @staticmethod
    def _median(samples) -> float | None:
        if not samples:
            return None
        s = sorted(samples)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def median_us(self, key: str) -> float | None:
        """Exact steady-state median us/call for a cell (None until the
        cell has a post-compile sample)."""
        with self._lock:
            cell = self._cells.get(key)
            med = self._median(cell.samples) if cell is not None else None
        return med * 1e6 if med is not None else None

    def cells(self) -> dict[str, dict]:
        """JSON-able snapshot: ``{cell_key: {count, median_us, first_us}}``
        — the payload ``MeasurementStore.ingest`` persists."""
        out = {}
        with self._lock:
            items = [(k, c.count, c.first_s, self._median(c.samples))
                     for k, c in self._cells.items()]
        for key, count, first_s, med in items:
            out[key] = {
                "count": count,
                "median_us": med * 1e6 if med is not None else None,
                "first_us": first_s * 1e6 if first_s is not None else None,
            }
        return out

    def dump(self) -> dict:
        return {"enabled": True, "cells": self.cells()}

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()


class NullKernelProfiler:
    """``obs=False`` twin: never installed by ``ops.launch_profiler``
    (``enabled`` is False), so no launch is ever synced or timed."""

    enabled = False

    def __init__(self, *_, **__):
        pass

    def observe_launch(self, **_) -> None:
        pass

    def median_us(self, key: str) -> None:
        return None

    def cells(self) -> dict:
        return {}

    def dump(self) -> dict:
        return {"enabled": False, "cells": {}}

    def reset(self) -> None:
        pass
