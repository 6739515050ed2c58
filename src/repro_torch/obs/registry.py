"""Low-overhead host-side metrics: counters, gauges, fixed-bucket histograms.

The registry is the common substrate the serving tiers' telemetry was
refactored onto (``UOTScheduler.stats()`` / ``ClusterScheduler.stats()``
read their running totals from registry counters; the public dict shapes
are unchanged). Design constraints, in order:

* **allocation-light** — a counter increment is one lock acquire and one
  int add; a histogram observation is a ``bisect`` plus two adds. No
  per-event objects, no timestamps (metrics are cumulative; *when* is the
  span tracer's job — see ``repro.obs.trace``).
* **deterministic** — nothing here reads a clock. Percentiles come from
  fixed bucket boundaries chosen at construction, so a test that drives a
  fake clock sees bit-reproducible dumps.
* **parent-chained** — a registry built with ``parent=`` forwards every
  increment/observation to the same-named metric of the parent (the
  ``ops.dispatch_counters`` stacking idiom, applied registry-wide). Each
  scheduler owns a private registry parented to the process-global one
  (``repro.obs.get_global()``), so per-scheduler ``stats()`` stay isolated
  while ``benchmarks/run.py`` dumps one process-wide ``OBS_<suite>.json``
  without touching any scheduler.
* **thread-safe** — one lock per registry guards its metric map and all
  its metrics' mutations; the async cluster step loop and background
  pollers may hammer the same counters from multiple threads
  (tests/test_obs.py races them).

Histogram percentiles are linearly interpolated inside the bucket that
holds the target rank and clamped to the observed [min, max], so they are
exact at the recorded extremes and within one bucket width of the true
order statistic everywhere else (asserted vs numpy in tests).
``percentile_from_state`` is the same estimator over a bare bucket-count
vector — the windowed-delta path (``repro.obs.windows`` subtracts two
cumulative ``Histogram.state()`` snapshots) computes percentiles through
it, and it is *total*: 0 observations return 0.0 and 1 observation
returns a value clamped inside its bucket, never NaN/None, so windowed
deltas can feed the exporters unguarded.
"""
from __future__ import annotations

import bisect
import threading


def percentile_from_state(buckets, counts, q: float,
                          lo: float | None = None,
                          hi: float | None = None) -> float:
    """Interpolated q-th percentile (q in [0, 100]) from bucket counts
    alone — ``counts`` has one overflow slot beyond ``buckets``' upper
    edges, exactly the ``Histogram.state()['counts']`` layout (or the
    element-wise difference of two such snapshots).

    Total by construction (the 0-/1-observation hardening):

    * **0 observations** -> ``0.0``. A windowed delta over a quiet
      period is an empty population; the documented sentinel is 0.0,
      matching ``Histogram.percentile`` on a fresh histogram.
    * **1 observation** -> the estimate interpolates inside the single
      occupied bucket and is clamped to that bucket's edges (to
      ``lo``/``hi`` when the caller knows the observed extremes), so it
      is finite and within one bucket width of the true value.

    ``lo``/``hi`` optionally clamp to observed extremes: the cumulative
    ``Histogram.percentile`` passes its exact min/max; windowed deltas
    cannot (min/max are not subtractable) and rely on bucket edges.
    """
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q / 100.0 * total
    cum = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= target:
            lo_edge = (buckets[i - 1] if i > 0
                       else (lo if lo is not None else min(0.0, buckets[0])))
            hi_edge = (buckets[i] if i < len(buckets)
                       else (hi if hi is not None else buckets[-1]))
            frac = (target - cum) / c
            est = lo_edge + (hi_edge - lo_edge) * max(0.0, min(1.0, frac))
            if lo is not None:
                est = max(lo, est)
            if hi is not None:
                est = min(hi, est)
            return est
        cum += c
    # float rounding pushed the target past the last occupied bucket
    return hi if hi is not None else buckets[-1]


def geometric_buckets(lo: float, hi: float, factor: float = 2.0) -> tuple:
    """Geometric bucket upper edges from ``lo`` until ``hi`` is covered."""
    if lo <= 0 or factor <= 1:
        raise ValueError("need lo > 0 and factor > 1")
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * factor)
    return tuple(edges)


# spans 1us .. ~1100s at 2x resolution: wide enough for wait/latency in
# both wall-clock and DES simulated seconds
DEFAULT_TIME_BUCKETS = geometric_buckets(1e-6, 1e3)
# iteration counts: 1 .. 16384
DEFAULT_COUNT_BUCKETS = geometric_buckets(1.0, 1e4)


class Counter:
    """Monotone running total. ``inc`` forwards to the parent chain."""

    __slots__ = ("name", "_value", "_lock", "_parent")

    def __init__(self, name: str, lock: threading.Lock, parent=None):
        self.name = name
        self._value = 0
        self._lock = lock
        self._parent = parent

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n
        if self._parent is not None:
            self._parent.inc(n)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-set value (occupancy, queue depth). ``set`` forwards up."""

    __slots__ = ("name", "_value", "_lock", "_parent")

    def __init__(self, name: str, lock: threading.Lock, parent=None):
        self.name = name
        self._value = 0.0
        self._lock = lock
        self._parent = parent

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
        if self._parent is not None:
            self._parent.set(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``buckets`` are the upper edges (ascending); values above the last
    edge land in an overflow bucket whose percentile estimate is the
    observed max. Memory is O(len(buckets)) forever — no sample is
    retained.
    """

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum", "_min",
                 "_max", "_lock", "_parent")

    def __init__(self, name: str, lock: threading.Lock, parent=None,
                 buckets=DEFAULT_TIME_BUCKETS):
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError("buckets must be strictly ascending")
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = lock
        self._parent = parent

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
        if self._parent is not None:
            self._parent.observe(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]): linear interpolation
        inside the target rank's bucket, clamped to the observed range.
        Total at every population size — 0 observations return 0.0, 1
        observation returns that observation (``percentile_from_state``'s
        clamp against the exact min/max collapses to it)."""
        if not self._count:
            return 0.0
        return percentile_from_state(self.buckets, self._counts, q,
                                     lo=self._min, hi=self._max)

    def state(self) -> dict:
        """Mergeable/subtractable cumulative state: ``{'counts', 'count',
        'sum', 'min', 'max'}`` with ``counts`` a tuple carrying the
        overflow slot. Two snapshots subtract element-wise into a
        windowed population (``repro.obs.windows``); min/max are reported
        for completeness but are NOT subtractable — windowed percentiles
        clamp to bucket edges instead (``percentile_from_state``)."""
        with self._lock:
            return {"counts": tuple(self._counts), "count": self._count,
                    "sum": self._sum,
                    "min": self._min if self._count else None,
                    "max": self._max if self._count else None}

    def raw(self) -> tuple:
        """``(counts, count, sum)`` under one lock acquire — the
        allocation-light form of ``state()`` the per-round window tick
        uses (``repro.obs.windows._snap`` runs inside the scheduler
        step, so this path is on the obs-overhead budget)."""
        with self._lock:
            return tuple(self._counts), self._count, self._sum

    def snapshot(self) -> dict:
        return {
            "count": self._count, "sum": self._sum,
            "min": self.min, "max": self.max, "mean": self.mean,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named metric namespace; get-or-create access, JSON-able dump.

    ``counter``/``gauge``/``histogram`` return the existing metric when the
    name is known (a name maps to exactly one kind — mixing kinds raises),
    so call sites never coordinate creation. With ``parent=`` every metric
    is chained to the parent's same-named metric, created on demand.
    """

    def __init__(self, *, parent: "MetricsRegistry | None" = None):
        self.parent = parent
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._sorted: list[tuple[str, object]] | None = None

    def _get_or_create(self, name: str, kind, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {kind.__name__}")
            return m
        parent_m = None
        if self.parent is not None:
            parent_m = self.parent._get_or_create(name, kind, **kwargs)
        m = kind(name, self._lock, parent=parent_m, **kwargs)
        with self._lock:
            # lost the creation race: keep the first one (its parent link
            # is identical — parent metrics are get-or-create too)
            m = self._metrics.setdefault(name, m)
            self._sorted = None
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets=DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram, buckets=buckets)

    def get(self, name: str):
        """The metric registered under ``name``, or None."""
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def metrics(self) -> list[tuple[str, object]]:
        """Stable (name, metric) snapshot of the namespace — the
        iteration surface ``repro.obs.windows`` ticks over and the
        Prometheus exporter renders from. The sorted list is cached and
        invalidated on registration (creation is rare after warmup; the
        per-round window tick calls this every time)."""
        with self._lock:
            if self._sorted is None:
                self._sorted = sorted(self._metrics.items())
            return self._sorted

    def dump(self) -> dict:
        """JSON-able snapshot: {'counters': {...}, 'gauges': {...},
        'histograms': {name: snapshot}} — the registry half of
        ``OBS_<suite>.json``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.snapshot()
        return out

    def reset(self) -> None:
        """Drop every metric (fresh namespace; chained children keep
        working — their parent link targets the old objects, so callers
        holding a child should re-create it after a reset; in practice
        resets happen between benchmark suites, before schedulers are
        built)."""
        with self._lock:
            self._metrics.clear()
            self._sorted = None
