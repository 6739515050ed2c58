"""PyTorch port, the resident tier: kernels f and g, ``resident_fits``,
``solve_fused_resident``, ``solve_fused_stepped_resident`` and the
``impl='auto'`` dispatch with its counters, observers and advisors.

The same numpy inputs go through the JAX reference — its Pallas resident
kernels in interpret mode and its ``resident_solve_jnp`` mirror — and
through the port's plain versions on the CPU.

Tolerances: fp32 couplings relative 1e-4 across the packages (summation
order differs), column sums likewise; iteration counts equal (the
problems' drift clears tol by a margin); final drifts, differences of
row factors near 1, within 1e-6 absolute where finite. bf16 the reference's bars, 5e-2 pointwise / 1e-2 mass.
Inside the port, chunk boundaries, closed lanes and finished lanes change
no bit.

The card's tests of kernels f and g are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import UOTConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import uot_resident as jur
from repro_torch.core import UOTConfig as TConfig
from repro_torch.core.sinkhorn_fused import sinkhorn_uot_fused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import uot_resident as tur

RTOL_SOLVE = 1e-4
BF16_POINT, BF16_MASS = 5e-2, 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def stack(B, M, N, seed, reg=0.1):
    """Random problem stack whose per-problem cost scale varies, so tol
    runs converge at different iteration counts."""
    rng = np.random.default_rng(seed)
    peaks = rng.uniform(1.0, 6.0, B)
    C = rng.uniform(0, 1, (B, M, N)).astype(np.float32) * peaks[:, None,
                                                                 None]
    a = rng.uniform(0.5, 1.5, (B, M)).astype(np.float32)
    b = rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)
    a = a / a.sum(1, keepdims=True)
    b = b / b.sum(1, keepdims=True) * 1.3
    K = np.exp(-C / reg) * (a[:, :, None] * b[:, None, :])
    return K.astype(np.float32), a, b


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, dname="float32"):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dname == "bfloat16":
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= BF16_POINT * scale
        assert abs(got.sum() - want.sum()) <= BF16_MASS * abs(want.sum())
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= RTOL_SOLVE, err


def cfgs(dname="float32", **kw):
    jdt, tdt = DTYPES[dname]
    kw = dict(dict(reg=0.1, reg_m=1.0, num_iters=30), **kw)
    return JConfig(dtype=jdt, **kw), TConfig(dtype=tdt, **kw)


def drift_close(got, want):
    got, want = f32(got), f32(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-3, atol=1e-6)


class TestKernelF:
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("tol", [None, 1e-3])
    def test_matches_pallas_kernel_and_jnp_mirror(self, dname, tol):
        jdt, tdt = DTYPES[dname]
        K, a, b = stack(3, 24, 130, 1)
        kw = dict(fi=1.0 / 1.1, num_iters=30, tol=tol)
        Kj = jnp.asarray(K, jdt)
        pk = jur.resident_solve(Kj, jnp.asarray(a), jnp.asarray(b),
                                interpret=True, **kw)
        pj = jur.resident_solve_jnp(Kj, jnp.asarray(a), jnp.asarray(b), **kw)
        At = torch.tensor(K).to(tdt)
        P, cs, it, err = tur.resident_solve(At, torch.tensor(a),
                                            torch.tensor(b), **kw)
        assert P is At and P.dtype == tdt             # in place
        assert it.dtype == torch.int32 and err.dtype == torch.float32
        for want in (pk, pj):
            close(P, want[0], dname)
            close(cs, want[1], dname)
            np.testing.assert_array_equal(it.numpy(), np.asarray(want[2]))
            drift_close(err, want[3])
        if tol is not None:
            assert len(set(it.tolist())) > 1          # heterogeneous counts
            assert (err <= tol).all()

    def test_ragged_lane_matches_core_solver(self):
        K, a, b = stack(2, 37, 99, 2)
        _, tc = cfgs(num_iters=500, tol=1e-5)
        P, cs, it, err = tur.resident_solve(
            torch.tensor(K), torch.tensor(a), torch.tensor(b), fi=tc.fi,
            num_iters=tc.num_iters, tol=tc.tol)
        for i in range(2):
            Pref, st = sinkhorn_uot_fused(torch.tensor(K[i]),
                                          torch.tensor(a[i]),
                                          torch.tensor(b[i]), tc)
            close(P[i], Pref)
            assert int(it[i]) == st["iters"] < 500

    def test_zero_iterations_and_counters(self):
        K, a, b = stack(2, 8, 16, 3)
        tur.reset_counts()
        P, cs, it, err = tur.resident_solve(
            torch.tensor(K), torch.tensor(a), torch.tensor(b), fi=0.9,
            num_iters=0, tol=1e-3)
        np.testing.assert_array_equal(P.numpy(), K)
        np.testing.assert_allclose(cs.numpy(), K.sum(1), rtol=1e-6)
        assert it.tolist() == [0, 0] and torch.isinf(err).all()
        assert tur.PLAIN_CALLS == {"resident_solve": 1,
                                   "resident_stepped": 0}
        assert tur.LAUNCHES == {"resident_solve": 0, "resident_stepped": 0}

    def test_wrapper_refuses_lanes_over_budget(self):
        with pytest.raises(ValueError, match="shared memory"):
            tur.resident_solve(torch.zeros(1, 256, 256), torch.zeros(1, 256),
                               torch.zeros(1, 256), fi=1.0, num_iters=1)
        with pytest.raises(ValueError, match="b must be"):
            tur.resident_solve(torch.zeros(1, 8, 16), torch.zeros(1, 8),
                               torch.zeros(1, 15), fi=1.0, num_iters=1)


def jax_pool(jc, L=4, M=28, N=130, seed=5):
    K, a, b = stack(L, M, N, seed)
    st = jops.make_lane_state(L, M, N, jc)
    return jops.lane_admit(st, jnp.arange(L), jnp.asarray(K),
                           jnp.asarray(a), jnp.asarray(b))


def port_pool(tc, L=4, M=28, N=130, seed=5):
    K, a, b = stack(L, M, N, seed)
    st = tops.make_lane_state(L, M, N, tc, device="cpu")
    return tops.lane_admit(st, list(range(L)), K, a, b)


def pool_numpy(st, M=28, N=130):
    return (f32(st.P)[:, :M, :N], f32(st.colsum)[:, :N],
            f32(st.frow)[:, :M], np.asarray(st.iters),
            np.asarray(st.converged))


class TestKernelG:
    @pytest.mark.parametrize("tol", [None, 1e-3])
    def test_matches_pallas_kernel(self, tol):
        jc, tc = cfgs(tol=tol)
        K, a, b = stack(4, 24, 130, 4)
        iters0 = np.array([0, 3, 29, 0], np.int32)
        conv0 = np.array([False, False, False, True])
        active = np.array([True, True, True, True])
        active[0] = False
        frow0 = np.ones((4, 24), np.float32)
        cs0 = K.sum(1)
        kw = dict(fi=tc.fi, n_iters=6, num_iters=30, tol=tol)
        out = jur.resident_stepped(
            jnp.asarray(K), jnp.asarray(cs0), jnp.asarray(frow0),
            jnp.asarray(iters0), jnp.asarray(conv0), jnp.asarray(active),
            jnp.asarray(a), jnp.asarray(b), interpret=True, **kw)
        P, cs, fr = torch.tensor(K), torch.tensor(cs0), torch.tensor(frow0)
        it, conv = torch.tensor(iters0), torch.tensor(conv0)
        tur.resident_stepped(P, cs, fr, it, conv, torch.tensor(active),
                             torch.tensor(a), torch.tensor(b), **kw)
        close(P, out[0])
        close(cs, out[1])
        close(fr, out[2])
        np.testing.assert_array_equal(it.numpy(), np.asarray(out[3]))
        np.testing.assert_array_equal(conv.numpy(),
                                      np.asarray(out[4]).astype(bool))
        # gate closed on entry: lane 0 (free) and lane 3 (converged) are
        # untouched; lane 2 stops at the cap after one iteration
        for lane in (0, 3):
            assert torch.equal(P[lane], torch.tensor(K[lane]))
            assert torch.equal(cs[lane], torch.tensor(cs0[lane]))
        assert it.tolist()[0] == 0 and it.tolist()[2] == 30
        if tol is None:
            assert it.tolist()[1] == 9

    @pytest.mark.parametrize("tol", [None, 1e-3])
    def test_pool_matches_reference_resident_pool(self, tol):
        jc, tc = cfgs(tol=tol)
        jst, tst = jax_pool(jc), port_pool(tc)
        jst = jops.lane_evict(jst, jnp.int32(2))
        tops.lane_evict(tst, 2)
        for _ in range(8):
            jst = jops.solve_fused_stepped_resident(jst, 4, jc, impl="kernel",
                                                    interpret=True)
            tops.solve_fused_stepped_resident(tst, 4, tc)
        for got, want in zip(pool_numpy(tst), pool_numpy(jst)):
            if got.dtype == np.float32:
                close(got, want)
            else:
                np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("tol", [None, 1e-3])
    def test_matches_streamed_stepped_pool(self, tol):
        """Resident chunks and streamed iterations of an fp32 pool: same
        iterates, counts and flags."""
        _, tc = cfgs(tol=tol)
        s, r = port_pool(tc), port_pool(tc)
        for _ in range(10):
            tops.solve_fused_stepped(s, 4, tc)
            tops.solve_fused_stepped_resident(r, 4, tc)
        for got, want in zip(pool_numpy(r), pool_numpy(s)):
            if got.dtype == np.float32:
                close(got, want)
            else:
                np.testing.assert_array_equal(got, want)

    def test_bf16_pool_within_reference_bars(self):
        jc, tc = cfgs("bfloat16", tol=1e-3)
        jst, tst = jax_pool(jc), port_pool(tc)
        for _ in range(8):
            jst = jops.solve_fused_stepped_resident(jst, 4, jc, impl="kernel",
                                                    interpret=True)
            tops.solve_fused_stepped_resident(tst, 4, tc)
        close(tst.P, f32(jst.P)[:, :28, :130], "bfloat16")
        np.testing.assert_array_equal(np.asarray(tst.iters),
                                      np.asarray(jst.iters))

    def test_chunk_boundaries_change_no_bit(self):
        """An fp32 resident pool's answer does not depend on the chunking,
        with a lane converging mid-chunk and a free lane in the pool."""
        _, tc = cfgs(tol=1e-3)
        fine, coarse = port_pool(tc), port_pool(tc)
        tops.lane_evict(fine, 2)
        tops.lane_evict(coarse, 2)
        for _ in range(30):
            tops.solve_fused_stepped_resident(fine, 1, tc)
        for _ in range(5):
            tops.solve_fused_stepped_resident(coarse, 6, tc)
        for got, want in zip(pool_numpy(fine), pool_numpy(coarse)):
            np.testing.assert_array_equal(got, want)
        assert int(fine.iters[2]) == 0 and float(fine.P[2].abs().max()) == 0
        assert len(set(fine.iters.tolist()) - {0}) > 1

    def test_finished_bf16_lanes_round_trip_bitwise(self):
        _, tc = cfgs("bfloat16", num_iters=10, tol=1e-2)
        st = port_pool(tc)
        for _ in range(10):
            tops.solve_fused_stepped_resident(st, 5, tc)
        assert bool(tops.lane_done(st, tc.num_iters)[st.active].all())
        before = [t.clone() for t in (st.P, st.colsum, st.frow, st.iters,
                                      st.converged)]
        tops.solve_fused_stepped_resident(st, 3, tc)
        for t, b in zip((st.P, st.colsum, st.frow, st.iters, st.converged),
                        before):
            assert torch.equal(t, b)

    def test_unhealthy_lane_freezes_neighbours_bit_identical(self):
        _, tc = cfgs(tol=1e-4)
        clean, poisoned = port_pool(tc), port_pool(tc)
        tops.solve_fused_stepped_resident(clean, 2, tc)
        tops.solve_fused_stepped_resident(poisoned, 2, tc)
        poisoned.P[1] = float("nan")
        poisoned.colsum[1] = float("nan")
        for _ in range(6):
            tops.solve_fused_stepped_resident(clean, 4, tc)
            tops.solve_fused_stepped_resident(poisoned, 4, tc)
        assert poisoned.healthy.tolist() == [True, False, True, True]
        assert bool(tops.lane_done(poisoned, tc.num_iters)[1])
        assert not bool(poisoned.converged[1])
        frozen_iters = int(poisoned.iters[1])
        tops.solve_fused_stepped_resident(clean, 4, tc)
        tops.solve_fused_stepped_resident(poisoned, 4, tc)
        assert int(poisoned.iters[1]) == frozen_iters   # enters as converged
        for lane in (0, 2, 3):
            assert torch.equal(clean.P[lane], poisoned.P[lane])
            assert clean.iters[lane] == poisoned.iters[lane]


class TestFitsAndDispatch:
    _, CFG = cfgs(num_iters=3)

    def test_fits_boundary_from_its_own_formula(self):
        """One block's shared memory holds the fp32 tile, four O(M+N)
        vectors and 32 floats: 4*(M*N + 2M + 2N + 32) <= 232448. At N=384
        that is M <= 148; the TPU's 2040x1024 boundary does not carry
        over."""
        assert tur.resident_smem_bytes(128, 384) == 200_832
        for sdt in (torch.float32, torch.bfloat16):
            assert tops.resident_fits(148, 384, self.CFG, storage_dtype=sdt)
            assert not tops.resident_fits(149, 384, self.CFG,
                                          storage_dtype=sdt)
            assert tops.resident_fits(128, 384, self.CFG, storage_dtype=sdt)
            assert not tops.resident_fits(256, 256, self.CFG,
                                          storage_dtype=sdt)
        assert not tops.resident_fits(2040, 1024, self.CFG)
        limit = tur.SMEM_LIMIT
        for M, N in [(1, 1), (64, 512), (100, 300), (227, 256), (16, 3000)]:
            assert tops.resident_fits(M, N, self.CFG) == (
                4 * (M * N + 2 * M + 2 * N + 32) <= limit)
        with pytest.raises(TypeError, match="storage dtype"):
            tops.resident_fits(8, 8, self.CFG, storage_dtype=torch.float16)

    def test_auto_routes_by_budget_and_matches_reference(self):
        jc, tc = cfgs(num_iters=40, tol=1e-3)
        K, a, b = stack(2, 24, 130, 8)
        Pj, csj = jops.solve_fused_batched(
            jnp.asarray(K), jnp.asarray(a), jnp.asarray(b), jc, impl="auto",
            interpret=True)
        tops.reset_dispatch_stats()
        with tops.dispatch_counters() as outer:
            Pt, cst = tops.solve_fused_batched(K, a, b, tc, impl="auto",
                                               device="cpu")
            with tops.dispatch_counters() as inner:
                Kw, aw, bw = stack(1, 160, 384, 9)
                tops.solve_fused_batched(Kw, aw, bw, tc, impl="auto",
                                         device="cpu")
            assert tops.dispatch_stats() == {"resident": 1, "streamed": 1}
        assert inner == {"resident": 0, "streamed": 1}
        assert outer == {"resident": 1, "streamed": 1}
        close(Pt, Pj)
        close(cst, csj)
        assert tops.dispatch_stats()["resident"] >= 1
        tops.reset_dispatch_stats()
        assert tops.dispatch_stats() == {"resident": 0, "streamed": 0}
        # an explicit impl is the caller's decision: nothing is counted
        tops.solve_fused_batched(K, a, b, tc, impl="resident", device="cpu")
        tops.solve_fused_batched(K, a, b, tc, device="cpu")
        assert tops.dispatch_stats() == {"resident": 0, "streamed": 0}

    def test_resident_batched_bf16_rounds_once(self):
        """bf16 storage on the resident tier is the fp32 trajectory
        rounded once: within one bf16 rounding of the fp32 solve."""
        _, tc16 = cfgs("bfloat16", num_iters=25)
        _, tc32 = cfgs(num_iters=25)
        K, a, b = stack(3, 32, 140, 3)
        P, _ = tops.solve_fused_batched(K, a, b, tc16, impl="resident",
                                        device="cpu")
        assert P.dtype == torch.bfloat16
        P32, _ = tops.solve_fused_batched(K, a, b, tc32, device="cpu")
        err = (P.float() - P32).abs().amax(dim=(1, 2)) / P32.abs().amax(
            dim=(1, 2))
        assert float(err.max()) <= 2 ** -8

    def test_observer_and_advisor(self):
        _, tc = cfgs(num_iters=5)
        K, a, b = stack(1, 16, 64, 10)
        seen = []

        class Streamer:
            def advise(self, **kw):
                seen.append(("advise", kw["stepped"]))
                return "streamed"

        def obs(kind, **kw):
            seen.append((kind, kw["M"], kw["N"], kw["itemsize"]))

        with tops.dispatch_observer(obs), tops.dispatch_counters() as c:
            tops.solve_fused(K[0], a[0], b[0], tc, impl="auto", device="cpu")
            with tops.dispatch_advisor(Streamer()):
                tops.solve_fused(K[0], a[0], b[0], tc, impl="auto",
                                 device="cpu")
                # advice never overrides an explicit impl
                tops.solve_fused(K[0], a[0], b[0], tc, impl="resident",
                                 device="cpu")
        assert c == {"resident": 1, "streamed": 1}
        assert seen == [("resident", 16, 64, 4), ("advise", False),
                        ("streamed", 16, 64, 4)]

    def test_stepped_auto_keeps_bf16_pools_streamed(self):
        jc32, tc32 = cfgs(num_iters=8, tol=1e-3)
        jc16, tc16 = cfgs("bfloat16", num_iters=8, tol=1e-3)
        with tops.dispatch_counters() as c:
            tops.solve_fused_stepped(port_pool(tc32), 2, tc32, impl="auto")
            st16 = port_pool(tc16)
            tops.solve_fused_stepped(st16, 2, tc16, impl="auto")
        assert c == {"resident": 1, "streamed": 1}
        # the bf16 pool streamed: it equals the reference's streamed pool
        jst = jops.solve_fused_stepped(jax_pool(jc16), 2, jc16,
                                       impl="kernel", interpret=True)
        close(st16.P, f32(jst.P)[:, :28, :130], "bfloat16")
        # explicit 'resident' still allows a bf16 pool
        tops.solve_fused_stepped(st16, 2, tc16, impl="resident")
        with pytest.raises(ValueError, match="resident budget"):
            tops.solve_fused_stepped(
                tops.make_lane_state(1, 256, 256, tc32, device="cpu"), 1,
                tc32, impl="resident")

    def test_bucketed_auto_resolves_per_chunk(self):
        jc, tc = cfgs(num_iters=20, tol=1e-4)
        K, a, b = stack(3, 24, 100, 11)
        Kw, aw, bw = stack(1, 180, 300, 12)
        problems = [(K[i], a[i], b[i]) for i in range(3)] + [
            (Kw[0], aw[0], bw[0])]
        with tops.dispatch_counters() as c:
            got = tops.solve_fused_bucketed(problems, tc, impl="auto",
                                            device="cpu")
        assert c == {"resident": 1, "streamed": 1}
        want = jops.solve_fused_bucketed(
            [tuple(jnp.asarray(x) for x in p) for p in problems], jc,
            impl="auto", interpret=True)
        for (Pt, cst), (Pj, csj) in zip(got, want):
            close(Pt, Pj)
            close(cst, csj)

