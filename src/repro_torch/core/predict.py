"""Per-request iteration prediction — the scheduler's service-time model.

Sinkhorn-family UOT solvers contract geometrically: the marginal error
after ``k`` iterations behaves like ``e0 * fi**k`` with
``fi = reg_m / (reg_m + reg)`` (Séjourné et al., arXiv:2201.00730 give
the translation-invariant contraction rate; Pham et al.,
arXiv:2002.03293 bound iterations in the same quantities). Inverting
gives the **analytic** iteration estimate

    iters ~= log(e0 / tol) / (-log fi),
    e0 = 1 + |log(mass(a) / mass(b))|

which captures the *trend* across (reg, reg_m, imbalance) well but
carries a roughly constant multiplicative bias (~0.4-0.6x measured on
the log-domain solver — the rate bound is loose by a constant). The
**online** layer absorbs that bias: ``IterPredictor`` keeps a per-
(bucket, imbalance-bin) EWMA of ``log(actual / analytic)`` fed by the
iteration telemetry both schedulers already record, so the first few
completions of a bucket calibrate every later prediction.

Serving uses this in three places (``repro.serve``'s overload model):

* **feasibility admission** — predicted service time vs the request's
  deadline, *before* burning lane time;
* **predicted-finish-time EDF** — queue ordering by least slack;
* **degrade labeling** — ``estimate_truncation_error`` turns a
  truncated iteration budget into the marginal-error label attached to
  level-1 degraded results.

Iterations become *seconds* via a per-iteration rate. Historically that
rate was an assumed constant (``seconds_per_iter=``) or a completion-fed
EWMA; ``measured_seconds_per_iter`` replaces the constant with measured
per-chunk service time from a ``repro.obs.measure.MeasurementStore`` —
the profiler's chunk cells record wall-clock us per L-lane
chunk_iters-iteration advance, and dividing by ``L * chunk_iters`` gives
the per-lane-iteration rate the service model wants. Both schedulers
consult it (``measurements=``) between the pinned value and the online
EWMA: pinned beats measured beats learned beats uncalibrated.

Everything here is host-side float arithmetic — nothing jitted, nothing
per-element; one ``predict`` costs a dict lookup and two ``log`` calls.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["analytic_iters", "predict_iters", "estimate_truncation_error",
           "IterPredictor", "measured_seconds_per_iter"]


def measured_seconds_per_iter(store, *, M: int | None = None,
                              N: int | None = None,
                              itemsize: int | None = None) -> float | None:
    """Seconds per lane-iteration from measured chunk cells.

    ``store`` is a ``repro.obs.measure.MeasurementStore`` (or None).
    ``M``/``N`` select one pool bucket's padded shape; None aggregates
    over every chunk cell (the bucketless rate ``_retry_after_hint``-
    style consumers want). Returns None when the store holds no matching
    steady-state chunk measurement — the caller falls back to its EWMA,
    never to a guess.
    """
    if store is None:
        return None
    us = store.us_per_lane_iter(kernel="chunk", M=M, N=N,
                                itemsize=itemsize)
    return us * 1e-6 if us is not None else None

# measured multiplicative bias of the analytic rate bound on the
# log-domain solver (see module docstring); the EWMA refines per bucket
_ANALYTIC_BIAS = 0.5
# default convergence target when the config runs without a tolerance
_DEFAULT_TOL = 1e-4


def _fi(reg: float, reg_m: float) -> float:
    if math.isinf(reg_m):
        return 1.0
    return reg_m / (reg_m + reg)


def analytic_iters(cfg, mass_a: float = 1.0, mass_b: float = 1.0) -> float:
    """Closed-form iteration estimate from the contraction rate.

    ``cfg`` is a ``core.problem.UOTConfig``; ``mass_a`` / ``mass_b`` are
    the marginal totals (their log-ratio is the imbalance mode the TI
    translation removes — kept in ``e0`` as a mild, always-safe bump).
    Returns a float, clipped to ``[1, cfg.num_iters]``; with no ``tol``
    the solver runs exactly ``cfg.num_iters``, so that is the answer.
    """
    if cfg.tol is None:
        return float(cfg.num_iters)
    fi = _fi(cfg.reg, cfg.reg_m)
    if fi >= 1.0:
        return float(cfg.num_iters)
    tol = max(cfg.tol, 1e-12)
    imb = abs(math.log(max(mass_a, 1e-12) / max(mass_b, 1e-12)))
    e0 = 1.0 + imb
    iters = _ANALYTIC_BIAS * math.log(max(e0 / tol, 1.0 + 1e-9)) / -math.log(fi)
    return float(min(max(iters, 1.0), cfg.num_iters))


def predict_iters(problem, cfg) -> float:
    """Analytic iteration estimate for a problem-like object.

    ``problem`` is anything with ``a`` / ``b`` marginal arrays (a
    ``ScheduledRequest``, a ``UOTProblem``, or a bare namespace); falls
    back to unit masses when they are absent. This is the stateless
    entry point — serving uses an ``IterPredictor`` instance so the
    estimate improves online.
    """
    a = getattr(problem, "a", None)
    b = getattr(problem, "b", None)
    mass_a = float(a.sum()) if a is not None else 1.0
    mass_b = float(b.sum()) if b is not None else 1.0
    return analytic_iters(cfg, mass_a, mass_b)


def estimate_truncation_error(cfg, iters: float,
                              mass_a: float = 1.0,
                              mass_b: float = 1.0) -> float:
    """Marginal-error estimate after truncating at ``iters`` iterations.

    The inverse of ``analytic_iters``: ``e0 * fi**(iters / bias)``. This
    is the error label serving attaches to level-1 (truncated-Sinkhorn)
    degraded results — same model, same units as ``cfg.tol``.
    """
    fi = _fi(cfg.reg, cfg.reg_m)
    imb = abs(math.log(max(mass_a, 1e-12) / max(mass_b, 1e-12)))
    e0 = 1.0 + imb
    if fi >= 1.0:
        return e0
    return float(e0 * fi ** (max(iters, 0.0) / _ANALYTIC_BIAS))


@dataclasses.dataclass
class _Cell:
    log_ratio: float = 0.0
    count: int = 0


class IterPredictor:
    """Analytic rate + per-(bucket, imbalance-bin) EWMA bias correction.

    ``observe`` feeds completed requests' actual iteration counts (the
    telemetry the schedulers already record at eviction); ``predict``
    multiplies the analytic estimate by ``exp(EWMA[log(actual /
    analytic)])`` for the request's cell, falling back — fine (bucket,
    imbalance-bin, reg, reg_m) -> per-(reg, reg_m) regime -> global ->
    raw analytic — while cells are cold. The state is a tiny host dict
    — safe to share across pools and configs, cheap to discard.
    """

    def __init__(self, alpha: float = 0.25, n_imb_bins: int = 4):
        self.alpha = alpha
        self.n_imb_bins = n_imb_bins
        self._cells: dict[tuple, _Cell] = {}
        self._global = _Cell()

    # -- keying ----------------------------------------------------------
    def _imb_bin(self, mass_a: float, mass_b: float) -> int:
        imb = abs(math.log(max(mass_a, 1e-12) / max(mass_b, 1e-12)))
        return min(int(imb / 0.5), self.n_imb_bins - 1)

    def _key(self, cfg, bucket, mass_a, mass_b):
        # (reg, reg_m) is in the key so one predictor instance shared
        # across configs (calibration sweeps, multi-tenant pools) never
        # blends contraction regimes; inside one scheduler cfg is fixed
        # and the key degenerates to (bucket, imbalance-bin)
        return (bucket, self._imb_bin(mass_a, mass_b),
                float(cfg.reg), float(cfg.reg_m))

    def _cfg_key(self, cfg):
        # the mid-level fallback: the analytic bias is chiefly a
        # function of the contraction regime (reg, reg_m), much less of
        # bucket/imbalance — a cold fine cell borrows its regime's bias
        # before falling back to the regime-mixed global
        return (float(cfg.reg), float(cfg.reg_m))

    # -- online update ---------------------------------------------------
    def observe(self, cfg, actual_iters: float, *, bucket=None,
                mass_a: float = 1.0, mass_b: float = 1.0) -> None:
        base = analytic_iters(cfg, mass_a, mass_b)
        if base <= 0 or actual_iters <= 0:
            return
        r = math.log(actual_iters / base)
        for cell in (self._cells.setdefault(
                self._key(cfg, bucket, mass_a, mass_b), _Cell()),
                self._cells.setdefault(self._cfg_key(cfg), _Cell()),
                self._global):
            if cell.count == 0:
                cell.log_ratio = r
            else:
                cell.log_ratio += self.alpha * (r - cell.log_ratio)
            cell.count += 1

    # -- prediction ------------------------------------------------------
    def predict(self, cfg, *, bucket=None, mass_a: float = 1.0,
                mass_b: float = 1.0) -> float:
        base = analytic_iters(cfg, mass_a, mass_b)
        cell = self._cells.get(self._key(cfg, bucket, mass_a, mass_b))
        if cell is None or cell.count == 0:
            cell = self._cells.get(self._cfg_key(cfg))
        if cell is None or cell.count == 0:
            cell = self._global
        if cell.count == 0:
            return base
        return float(min(max(base * math.exp(cell.log_ratio), 1.0),
                         cfg.num_iters))

    def snapshot(self) -> dict:
        """Cell table for ``stats()`` / debugging."""
        out = {"global": (self._global.log_ratio, self._global.count)}
        for k, c in self._cells.items():
            out[str(k)] = (c.log_ratio, c.count)
        return out
