"""PyTorch port, steppable lane pools (``LaneState``, ``lane_admit`` /
``lane_evict`` / ``lane_done``, ``solve_fused_stepped``) and the pool
conversion between the two packages.

The JAX side runs its Pallas stepped kernel in interpret mode
(``impl='kernel', interpret=True``); the port runs its plain versions on
the CPU. Tolerances: fp32 couplings relative 1e-4 across the packages,
bf16 the reference's 5e-2 pointwise / 1e-2 mass; iteration counts equal
(the problems' drift clears tol by a margin). Inside the port, chunk
boundaries and a poisoned neighbour lane change no bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import UOTConfig as JConfig
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import UOTConfig as TConfig
from repro_torch.kernels import ops as tops

BF16_POINT, BF16_MASS = 5e-2, 1e-2
RTOL_SOLVE = 1e-4


def problem(M, N, seed, reg=0.1, peak=1.0):
    rng = np.random.default_rng(seed)
    C = rng.uniform(0, 1, (M, N)).astype(np.float32) * peak
    a = rng.uniform(0.5, 1.5, M).astype(np.float32)
    b = rng.uniform(0.5, 1.5, N).astype(np.float32)
    a, b = a / a.sum(), b / b.sum() * 1.2
    return (np.exp(-C / reg) * (a[:, None] * b[None, :])).astype(
        np.float32), a, b


# (lane, shape, seed, peak): heterogeneous convergence speeds
LANES = [(0, (20, 100), 1, 1.0), (1, (32, 128), 2, 4.0), (3, (9, 57), 3, 2.0)]
POOL = (4, 32, 128)


def cfgs(dtype="float32", tol=1e-5, num_iters=30):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(reg=0.1, reg_m=1.0, num_iters=num_iters, tol=tol)
    return JConfig(dtype=jdt, **kw), TConfig(dtype=tdt, **kw)


def jax_pool(jc):
    st = jops.make_lane_state(*POOL, jc)
    for lane, (m, n), seed, peak in LANES:
        K, a, b = problem(m, n, seed, peak=peak)
        st = jops.lane_admit(st, jnp.int32(lane), jnp.asarray(K),
                             jnp.asarray(a), jnp.asarray(b))
    return st


def port_pool(tc):
    st = tops.make_lane_state(*POOL, tc, device="cpu")
    for lane, (m, n), seed, peak in LANES:
        tops.lane_admit(st, lane, *problem(m, n, seed, peak=peak))
    return st


def jax_step(st, jc, chunks, chunk=5):
    for _ in range(chunks):
        st = jops.solve_fused_stepped(st, chunk, jc, interpret=True,
                                      impl="kernel")
    return st


def port_step(st, tc, chunks, chunk=5):
    for _ in range(chunks):
        tops.solve_fused_stepped(st, chunk, tc)
    return st


def assert_pools_match(tst, jst, dtype="float32"):
    for lane, (m, n), _, _ in LANES:
        got = tst.P[lane, :m, :n].float().numpy()
        want = np.asarray(jst.P[lane, :m, :n], np.float32)
        if dtype == "bfloat16":
            assert np.abs(got - want).max() <= BF16_POINT * np.abs(want).max()
            assert abs(got.sum() - want.sum()) <= BF16_MASS * want.sum()
        else:
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= RTOL_SOLVE, (lane, err)
    np.testing.assert_array_equal(tst.iters.numpy(), np.asarray(jst.iters))
    np.testing.assert_array_equal(tst.converged.numpy(),
                                  np.asarray(jst.converged))
    np.testing.assert_array_equal(tst.healthy.numpy(),
                                  np.asarray(jst.healthy))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_admit_step_evict_matches_reference(dtype):
    jc, tc = cfgs(dtype)
    jst, tst = jax_step(jax_pool(jc), jc, 6), port_step(port_pool(tc), tc, 6)
    assert_pools_match(tst, jst, dtype)
    np.testing.assert_array_equal(
        tops.lane_done(tst, tc.num_iters).numpy(),
        np.asarray(jops.lane_done(jst, jc.num_iters)))
    jst = jops.lane_evict(jst, jnp.int32(1))
    tops.lane_evict(tst, 1)
    assert not bool(tst.active[1]) and not bool(jst.active[1])
    assert float(tst.P[1].abs().sum()) == 0.0
    assert tst.m_valid.tolist() == np.asarray(jst.m_valid).tolist()


def test_chunk_boundaries_change_no_bit():
    _, tc = cfgs(tol=1e-4, num_iters=40)
    finals = []
    for chunk in (1, 4, 7):
        st = port_pool(tc)
        for _ in range(40):
            tops.solve_fused_stepped(st, chunk, tc)
            if bool(tops.lane_done(st, tc.num_iters)[[0, 1, 3]].all()):
                break
        finals.append((st.P.clone(), st.iters.clone()))
    for P, iters in finals[1:]:
        assert torch.equal(P, finals[0][0])
        assert torch.equal(iters, finals[0][1])


def test_poisoned_lane_latches_unhealthy_neighbours_bit_identical():
    _, tc = cfgs()
    clean, poisoned = port_pool(tc), port_pool(tc)
    K, a, b = problem(16, 64, 9)
    K_bad = K.copy()
    K_bad[3, 5] = np.nan
    tops.lane_admit(clean, 2, K, a, b)
    tops.lane_admit(poisoned, 2, K_bad, a, b)
    port_step(clean, tc, 3)
    port_step(poisoned, tc, 3)
    assert not bool(poisoned.healthy[2]) and bool(clean.healthy[2])
    assert int(poisoned.iters[2]) == 1         # frozen the iteration it broke
    assert bool(tops.lane_done(poisoned, tc.num_iters)[2])
    for lane in (0, 1, 3):
        assert torch.equal(poisoned.P[lane], clean.P[lane])
        assert torch.equal(poisoned.colsum[lane], clean.colsum[lane])
        assert int(poisoned.iters[lane]) == int(clean.iters[lane])
    tops.lane_evict(poisoned, 2)               # eviction scrubs the NaNs
    assert bool(torch.isfinite(poisoned.P).all())


def test_reference_pool_continued_by_the_port():
    jc, tc = cfgs()
    jst = jax_step(jax_pool(jc), jc, 2)
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.FIELDS}
    Mp, Np = arrays["P"].shape[1:]
    tst = convert.lane_state_from_numpy(arrays, "cpu", M=POOL[1], N=POOL[2])
    assert tuple(tst.P.shape) == POOL
    port_step(tst, tc, 4)
    jst = jax_step(jst, jc, 4)
    assert_pools_match(tst, jst)
    back = convert.lane_state_to_numpy(tst, M=Mp, N=Np)
    assert back["P"].shape == (POOL[0], Mp, Np)
    assert np.all(back["frow"][:, POOL[1]:] == 1.0)


def test_admission_masks_beyond_valid_counts():
    _, tc = cfgs()
    st = tops.make_lane_state(2, 8, 16, tc, device="cpu")
    K = np.ones((8, 16), np.float32)
    tops.lane_admit(st, [1], K[None], np.ones((1, 8), np.float32),
                    np.ones((1, 16), np.float32), m_valid=5, n_valid=10)
    assert float(st.P[1, 5:].abs().sum()) == 0.0
    assert float(st.P[1, :, 10:].abs().sum()) == 0.0
    assert st.colsum[1].tolist() == [5.0] * 10 + [0.0] * 6
    assert (st.m_valid.tolist(), st.n_valid.tolist()) == ([0, 5], [0, 10])
    with pytest.raises(ValueError, match="does not fit"):
        tops.lane_admit(st, 0, np.ones((9, 16), np.float32),
                        np.ones(9, np.float32), np.ones(16, np.float32))


def test_stepped_later_slices_raise():
    """impl='auto' is ported: an fp32 pool inside the resident budget runs
    on kernel g, a bf16 pool stays streamed (kernel g would round it once
    per chunk); both match the reference's own 'auto' pool."""
    for dtype, want in (("float32", "resident"), ("bfloat16", "streamed")):
        jc, tc = cfgs(dtype)
        jst, tst = jax_pool(jc), port_pool(tc)
        with tops.dispatch_counters() as routed:
            for _ in range(4):
                jst = jops.solve_fused_stepped(jst, 5, jc, interpret=True,
                                               impl="auto")
                tops.solve_fused_stepped(tst, 5, tc, impl="auto")
        assert routed == dict({"resident": 0, "streamed": 0}, **{want: 4})
        assert_pools_match(tst, jst, dtype)
