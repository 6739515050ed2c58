"""PyTorch port, serving: ``UOTBatchEngine.flush`` and ``UOTScheduler``
against their JAX counterparts on the same request trace.

Both schedulers run under one injected clock that the test advances, so
waits, latencies and deadline misses are comparable exactly. The JAX side
runs its Pallas kernels in interpret mode (``impl='kernel',
interpret=True``); the port runs its plain versions on the CPU.
Tolerances: fp32 couplings relative 1e-4; statuses, iteration counts and
``stats()`` counters equal (the trace's problems clear tol by a margin).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import InvalidProblemError as JInvalidProblemError
from repro.core import UOTConfig as JConfig
from repro.serve import UOTBatchEngine as JEngine
from repro.serve import UOTScheduler as JScheduler
from repro_torch.core import InvalidProblemError
from repro_torch.core import UOTConfig as TConfig
from repro_torch.kernels import ops as tops
from repro_torch.serve import (QueueFullError, RequestFailure,
                               UOTBatchEngine, UOTScheduler,
                               submit_with_retry)

RTOL_SOLVE = 1e-4
SHAPES = [(20, 100), (30, 120), (10, 60), (32, 128), (25, 90), (12, 50),
          (28, 110), (16, 70)]


def problem(M, N, seed, reg=0.1, peak=1.0):
    rng = np.random.default_rng(seed)
    C = rng.uniform(0, 1, (M, N)).astype(np.float32) * peak
    a = rng.uniform(0.5, 1.5, M).astype(np.float32)
    b = rng.uniform(0.5, 1.5, N).astype(np.float32)
    a, b = a / a.sum(), b / b.sum() * 1.2
    return (np.exp(-C / reg) * (a[:, None] * b[None, :])).astype(
        np.float32), a, b


def trace():
    return [problem(m, n, 100 + i, peak=1.0 + (i % 3) * 2.0)
            for i, (m, n) in enumerate(SHAPES)]


def cfgs(**kw):
    base = dict(reg=0.1, reg_m=1.0, num_iters=30, tol=1e-5)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive(sched, clock, reqs, *, fault_rid=None):
    """Submit the trace with staggered deadlines, then step to drain,
    advancing the clock 10 ms a round."""
    for i, (K, a, b) in enumerate(reqs):
        sched.submit(K, a, b, deadline=0.04 + 0.01 * (i % 4),
                     priority=i % 2)
    out = {}
    steps = 0
    while sched.pending or sched.in_flight:
        out.update(sched.step())
        if steps == 0 and fault_rid is not None:
            assert sched.inject_lane_fault(fault_rid)
        clock.t += 0.01
        steps += 1
    out.update(sched.run())
    return out


def make_pair(**kw):
    jc, tc = cfgs()
    jclock, tclock = Clock(), Clock()
    common = dict(lanes_per_pool=4, chunk_iters=5, m_bucket=32)
    common.update(kw)
    js = JScheduler(jc, clock=jclock, interpret=True, impl="kernel",
                    **common)
    ts = UOTScheduler(tc, clock=tclock, device="cpu", **common)
    return (js, jclock), (ts, tclock)


def assert_same_serving(js, ts, jout, tout):
    assert sorted(jout) == sorted(tout)
    for rid in jout:
        assert tout[rid].dtype == np.float32
        assert rel(tout[rid], jout[rid]) <= RTOL_SOLVE, rid
    jlog = {r.rid: r for r in js.request_log}
    tlog = {r.rid: r for r in ts.request_log}
    assert sorted(jlog) == sorted(tlog)
    for rid, jr in jlog.items():
        tr = tlog[rid]
        assert (tr.status, tr.iters, tr.converged, tr.lane, tr.bucket) == (
            jr.status, jr.iters, jr.converged, jr.lane, jr.bucket), rid
        assert (tr.admitted, tr.completed) == (jr.admitted, jr.completed)
    jstats, tstats = js.stats(), ts.stats()
    assert tstats.keys() == jstats.keys()
    for k, v in jstats.items():
        if isinstance(v, float):
            assert tstats[k] == pytest.approx(v), k
        else:
            assert tstats[k] == v, k


def test_scheduler_matches_reference_on_a_trace():
    (js, jclock), (ts, tclock) = make_pair()
    reqs = trace()
    jout = drive(js, jclock, reqs)
    tout = drive(ts, tclock, reqs)
    assert_same_serving(js, ts, jout, tout)
    assert ts.stats()["deadline_misses"] > 0      # the trace is tight
    counters = ts.obs.registry.dump()["counters"]
    assert counters["serve.completed"] == len(reqs)


def test_quarantine_and_log_domain_retry_match_reference():
    (js, jclock), (ts, tclock) = make_pair()
    reqs = trace()[:3]
    jout = drive(js, jclock, reqs, fault_rid=1)
    tout = drive(ts, tclock, reqs, fault_rid=1)
    assert_same_serving(js, ts, jout, tout)
    assert {r.rid: r.status for r in ts.request_log}[1] == "retried_ok"
    assert ts.stats()["unhealthy_evictions"] == 1


def test_shed_drop_and_rejection_resolve_at_poll():
    (js, _), (ts, _) = make_pair(shed_policy="drop")
    for sched in (js, ts):
        K, a, b = problem(10, 40, 1)
        late = sched.submit(K, a, b, deadline=-1.0)
        with pytest.raises((InvalidProblemError,
                            JInvalidProblemError)) as info:
            sched.submit(K, a * np.nan, b)
        assert info.value.reason == "non_finite"
        bad = info.value.rid
        sched.run()
        for rid in (late, bad):
            failure = sched.poll(rid)
            assert failure.status == "rejected"
            if sched is ts:
                assert isinstance(failure, RequestFailure)
        assert sched.poll(late) is None                # take semantics
    assert ts.stats()["shed_dropped"] == js.stats()["shed_dropped"] == 1
    assert ts.stats()["rejected"] == js.stats()["rejected"] == 2


def test_backpressure_and_bounded_results():
    _, tc = cfgs()
    ts = UOTScheduler(tc, device="cpu", max_queue=2, max_results=1,
                      sleep=lambda s: None)
    K, a, b = problem(8, 30, 2)
    ts.submit(K, a, b)
    ts.submit(K, a, b)
    with pytest.raises(QueueFullError) as info:
        ts.submit(K, a, b)
    assert info.value.queue_depth == 2 and info.value.retry_after is None
    with pytest.raises(QueueFullError):
        submit_with_retry(ts, K, a, b, attempts=2)
    ts.run()
    assert ts.poll(0).status == "lost"
    assert ts.poll(1).shape == (8, 30)
    assert ts.stats()["lost_results"] == 1


@pytest.mark.parametrize("kw", [
    dict(predictive=True), dict(shed_policy="degrade"),
    dict(measurements=object()), dict(fault_injector=object()),
    dict(slos=[object()]), dict(brownout=object())])
def test_later_slice_features_raise(kw):
    _, tc = cfgs()
    with pytest.raises(NotImplementedError):
        UOTScheduler(tc, device="cpu", **kw)


def test_submit_points_raises():
    """Point requests are refused as the reference refuses them: clouds of
    different d (``ValueError``), a full queue, an invalid problem."""
    _, tc = cfgs()
    x, y = np.zeros((4, 3), np.float32), np.zeros((5, 2), np.float32)
    a, b = np.full(4, 0.25, np.float32), np.full(5, 0.2, np.float32)
    with pytest.raises(ValueError, match="coordinate dims"):
        UOTScheduler(tc, device="cpu").submit_points(x, y, a, b)
    with pytest.raises(ValueError, match="coordinate dims"):
        UOTBatchEngine(tc, device="cpu").submit_points(x, y, a, b)
    sched = UOTScheduler(tc, device="cpu", max_queue=1)
    y3 = np.zeros((5, 3), np.float32)
    sched.submit_points(x, y3, a, b)
    with pytest.raises(QueueFullError):
        sched.submit_points(x, y3, a, b)
    with pytest.raises(InvalidProblemError):
        UOTScheduler(tc, device="cpu").submit_points(x, y3, -a, b)


@pytest.mark.parametrize("tol", [None, 1e-5])
def test_engine_flush_matches_reference(tol):
    jc, tc = cfgs(tol=tol, num_iters=20)
    je = JEngine(jc, max_batch=4, m_bucket=32, interpret=True, impl="kernel")
    te = UOTBatchEngine(tc, max_batch=4, m_bucket=32, device="cpu")
    for K, a, b in trace():
        assert je.submit(jnp.asarray(K), a, b) == te.submit(K, a, b)
    assert te.pending == len(SHAPES)
    jout, tout = je.flush(), te.flush()
    assert sorted(jout) == sorted(tout)
    for rid in jout:
        assert tout[rid].shape == SHAPES[rid]
        assert rel(tout[rid], jout[rid]) <= RTOL_SOLVE
    jc_ = je.obs.registry.dump()["counters"]
    tc_ = te.obs.registry.dump()["counters"]
    for name in ("engine.submitted", "engine.flushes", "engine.flushed"):
        assert tc_[name] == jc_[name]
    assert te.flush() == {}


def test_bf16_scheduler_within_reference_bars():
    jc, _ = cfgs(dtype=jnp.bfloat16)
    _, tc = cfgs(dtype=torch.bfloat16)
    js = JScheduler(jc, lanes_per_pool=4, chunk_iters=5, m_bucket=32,
                    interpret=True, impl="kernel")
    ts = UOTScheduler(tc, lanes_per_pool=4, chunk_iters=5, m_bucket=32,
                      device="cpu")
    reqs = trace()[:4]
    for s in (js, ts):
        for K, a, b in reqs:
            s.submit(K, a, b)
    jout, tout = js.run(), ts.run()
    for rid, P in jout.items():
        want, got = np.asarray(P, np.float32), tout[rid]
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
        assert abs(got.sum() - want.sum()) <= 1e-2 * want.sum()


def test_auto_engine_and_scheduler_route_and_match_reference():
    """impl='auto': the (32, 128) bucket fits the Hopper resident budget
    and runs on kernels f (engine) / g (scheduler); the (160, 384) bucket
    does not and streams. The reference's TPU budget keeps both resident,
    and the answers, statuses and iteration counts agree all the same."""
    reqs = trace() + [problem(150, 300, 7, peak=2.0)]
    jc, tc = cfgs(num_iters=30)
    je = JEngine(jc, max_batch=4, m_bucket=32, interpret=True, impl="auto")
    te = UOTBatchEngine(tc, max_batch=4, m_bucket=32, device="cpu",
                        impl="auto")
    for K, a, b in reqs:
        assert je.submit(jnp.asarray(K), a, b) == te.submit(K, a, b)
    with tops.dispatch_counters() as routed:
        jout, tout = je.flush(), te.flush()
    assert routed == {"resident": 2, "streamed": 1}     # 8 small in 2 chunks
    assert te.last_dispatch == {(32, 128): "resident",
                                (160, 384): "streamed"}
    for rid in jout:
        assert rel(tout[rid], jout[rid]) <= RTOL_SOLVE

    jclock, tclock = Clock(), Clock()
    common = dict(lanes_per_pool=4, chunk_iters=5, m_bucket=32, impl="auto")
    js = JScheduler(jc, clock=jclock, interpret=True, **common)
    ts = UOTScheduler(tc, clock=tclock, device="cpu", **common)
    jout = drive(js, jclock, reqs)
    tout = drive(ts, tclock, reqs)
    assert_same_serving(js, ts, jout, tout)
    counters = ts.obs.registry.dump()["counters"]
    assert counters["serve.dispatch.resident"] > 0
    assert counters["serve.dispatch.streamed"] > 0
    jcounters = js.obs.registry.dump()["counters"]
    assert (counters["serve.dispatch.resident"]
            + counters["serve.dispatch.streamed"]
            == jcounters["serve.dispatch.resident"])
