"""Per-request trace spans: the full lifecycle of every rid, exportable.

A *span* is the ordered event list of one request id. Events are flat
dicts ``{"rid", "event", "t", **fields}`` — ``t`` comes from the
injected clock (the scheduler's own, so DES benches get simulated
timestamps and fake-clock tests stay deterministic). The schedulers emit:

========== ============================================================
event      meaning / fields
========== ============================================================
submit     request accepted by ``submit``/``submit_points``; ``M``,
           ``N``, ``bucket``, ``kind`` ('dense'|'points'), ``deadline``,
           ``priority``
queue      entered the admission (or gang) queue; ``depth``, ``route``
shed       deadline-shed decision at admission; ``policy``
place      got a lane; ``device`` (-1 single-device), ``lane``,
           ``bucket`` (the *pool's* — wider when pool-shared), ``route``
chunk      observed between chunk advances while in a lane; ``lane``,
           ``device``, ``iters``, ``converged``, ``healthy``
evict      left its lane; ``lane``, ``device``, ``iters``,
           ``converged``, ``healthy``
requeue    cluster drain/poison bounce back into the queue; ``retries``
escalate   log-domain retry of a quarantined request; ``retries``
gang       solved on the gang tier; ``devices``, ``iters``
complete   TERMINAL — exactly one per rid; ``status`` in ok /
           retried_ok / timed_out / failed / rejected (+ ``iters``,
           ``reason`` where meaningful)
lost       the *coupling* fell off the bounded result store after
           completion (poll now resolves to a 'lost' failure); the
           complete event stays the terminal span record
poll       client collected the rid; ``resolved``
           ('coupling'|'failure'|'pending')
========== ============================================================

The zero-span-loss invariant (asserted by ``bench_serve`` /
``bench_chaos`` and the chaos CI job) is ``check_complete()``: every
submitted rid carries exactly one ``complete`` event. ``terminal_status``
folds a later ``lost`` marker in, matching what ``poll`` would return.

Control-plane events use **negative rids**: the SLO monitor
(``repro.obs.slo``) emits ``alert`` transitions under rid ``-1``. They
carry no request lifecycle, so ``rids()`` and ``check_complete`` skip
negative rids — an alert never shows up as a lost span. ``span(-1)``
still returns them for inspection.

Export is JSONL (one event per line, ``write_jsonl``/``load_jsonl``
round-trip exactly) and ``render_timeline`` draws a text timeline for
humans. ``NullTracer`` is the disabled twin: same surface, ``emit`` is a
no-op — the obs-overhead CI job measures on-vs-off with it.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Iterable

TERMINAL_STATUSES = ("ok", "retried_ok", "timed_out", "failed", "rejected",
                     "lost")


class SpanTracer:
    """Append-only per-request event recorder (see module docstring)."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.events: list[dict] = []

    def emit(self, rid: int, event: str, **fields) -> None:
        e = {"rid": rid, "event": event, "t": self.clock()}
        e.update(fields)
        self.events.append(e)

    def clear(self) -> None:
        self.events.clear()

    # ---- span queries -----------------------------------------------------

    def rids(self) -> list[int]:
        """Every *request* rid that emitted at least one event, in
        first-seen order. Negative rids are control-plane events (SLO
        alerts) and are excluded — use ``span(-1)`` to read them."""
        seen: dict[int, None] = {}
        for e in self.events:
            if e["rid"] >= 0:
                seen.setdefault(e["rid"], None)
        return list(seen)

    def span(self, rid: int) -> list[dict]:
        return [e for e in self.events if e["rid"] == rid]

    def terminal_status(self, rid: int) -> str | None:
        """What ``poll`` resolves this rid to: the ``complete`` status,
        overridden by 'lost' when the coupling later fell off the result
        store; None while the request is still pending."""
        status = None
        for e in self.events:
            if e["rid"] != rid:
                continue
            if e["event"] == "complete":
                status = e["status"]
            elif e["event"] == "lost":
                status = "lost"
        return status

    def check_complete(self, submitted=None) -> dict:
        """The zero-span-loss audit. Returns ``{'total', 'missing',
        'multiple'}`` — rids with no / more-than-one terminal ``complete``
        event. ``submitted`` (iterable of rids) widens the audited set
        beyond the rids that emitted events (a rid with NO events at all
        is a lost span too). An empty ``missing`` + ``multiple`` is the
        invariant benches and the chaos CI job assert."""
        counts: dict[int, int] = {}
        for rid in self.rids():
            counts[rid] = 0
        if submitted is not None:
            for rid in submitted:
                counts.setdefault(rid, 0)
        for e in self.events:
            if e["event"] == "complete":
                counts[e["rid"]] = counts.get(e["rid"], 0) + 1
        return {
            "total": len(counts),
            "missing": sorted(r for r, c in counts.items() if c == 0),
            "multiple": sorted(r for r, c in counts.items() if c > 1),
        }

    # ---- export -----------------------------------------------------------

    def write_jsonl(self, path) -> int:
        """One event per line; returns the number of lines written."""
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")
        return len(self.events)

    @staticmethod
    def load_jsonl(path) -> list[dict]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    @classmethod
    def from_events(cls, events: Iterable[dict],
                    clock: Callable[[], float] = time.monotonic):
        """Rebuild a tracer around exported events (JSONL reload)."""
        tr = cls(clock=clock)
        tr.events = list(events)
        return tr

    # ---- human rendering --------------------------------------------------

    def render_timeline(self, rids=None, width: int = 60) -> str:
        """Text timeline: one row per rid, event initials placed
        proportionally between the trace's first and last timestamp,
        terminal status at the right edge. For eyeballs, not parsers —
        the JSONL export is the machine surface."""
        if not self.events:
            return "(no events)"
        rids = list(rids) if rids is not None else self.rids()
        t0 = min(e["t"] for e in self.events)
        t1 = max(e["t"] for e in self.events)
        dt = (t1 - t0) or 1.0
        initials = {"submit": "S", "queue": "q", "shed": "x", "place": "P",
                    "chunk": ".", "evict": "E", "requeue": "r",
                    "escalate": "!", "gang": "G", "complete": "C",
                    "lost": "L", "poll": "p"}
        lines = [f"t0={t0:.6f}  span={dt:.6f}s  "
                 f"({len(self.events)} events, {len(rids)} rids)"]
        for rid in rids:
            row = [" "] * width
            status = None
            for e in self.span(rid):
                pos = min(width - 1, int((e["t"] - t0) / dt * (width - 1)))
                row[pos] = initials.get(e["event"], "?")
                if e["event"] == "complete":
                    status = e["status"]
                elif e["event"] == "lost":
                    status = "lost"
            lines.append(f"rid {rid:>6} |{''.join(row)}| "
                         f"{status or 'pending'}")
        return "\n".join(lines)


class NullTracer:
    """Disabled tracer: same surface as ``SpanTracer``, ``emit`` drops the
    event. ``events`` stays an empty tuple so accidental iteration is
    harmless and zero-cost."""

    enabled = False
    events: tuple = ()

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock

    def emit(self, rid: int, event: str, **fields) -> None:
        pass

    def clear(self) -> None:
        pass

    def rids(self) -> list:
        return []

    def span(self, rid: int) -> list:
        return []

    def terminal_status(self, rid: int):
        return None

    def check_complete(self, submitted=None) -> dict:
        return {"total": 0, "missing": [], "multiple": []}

    def write_jsonl(self, path) -> int:
        with open(path, "w"):
            pass
        return 0

    load_jsonl = staticmethod(SpanTracer.load_jsonl)

    def render_timeline(self, rids=None, width: int = 60) -> str:
        return "(tracing disabled)"
