"""PyTorch port, kernels a and b and the single-problem ``solve_fused``.

The same numpy inputs go through the JAX reference — its Pallas kernels in
interpret mode, as the reference's own tests run them on the CPU — and
through the port, whose wrappers take their plain PyTorch versions for CPU
tensors. The reference kernels want M padded to a multiple of the row
block; zero rows (a = 0) are exact no-ops, so the port gets the ragged
shape and the reference the padded one.

Tolerances (summation order differs between the two):
  * fp32 per kernel call: rtol 1e-5, atol 1e-7;
  * fp32 whole solves: relative 1e-4; iteration counts equal;
  * bf16: the reference's bars, 5e-2 pointwise and 1e-2 mass
    (tests/test_bf16_accumulation.py).

The card's tests of kernels a and b are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import UOTConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import uot_fused as juf
from repro_torch.core import UOTConfig as TConfig
from repro_torch.core.sinkhorn_fused import sinkhorn_uot_fused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import uot_batched as ub
from repro_torch.kernels import uot_fused as tuf

F32_CALL = dict(rtol=1e-5, atol=1e-7)
RTOL_SOLVE = 1e-4
BF16_POINT, BF16_MASS = 5e-2, 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def problem(M, N, seed, reg=0.1, peak=1.0):
    rng = np.random.default_rng(seed)
    C = rng.uniform(0, 1, (M, N)).astype(np.float32) * peak
    a = rng.uniform(0.5, 1.5, M).astype(np.float32)
    b = rng.uniform(0.5, 1.5, N).astype(np.float32)
    a, b = a / a.sum(), b / b.sum() * 1.2
    return (np.exp(-C / reg) * (a[:, None] * b[None, :])).astype(
        np.float32), a, b


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, dname, *, call=True):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dname == "bfloat16":
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= BF16_POINT * scale
        assert abs(got.sum() - want.sum()) <= BF16_MASS * abs(want.sum())
    elif call:
        np.testing.assert_allclose(got, want, **F32_CALL)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= RTOL_SOLVE, err


def pad_rows(x, bm):
    p = (-x.shape[0]) % bm
    return np.pad(x, [(0, p)] + [(0, 0)] * (x.ndim - 1)) if p else x


def cfgs(dname="float32", **kw):
    jdt, tdt = DTYPES[dname]
    kw = dict(dict(reg=0.1, reg_m=1.0, num_iters=15), **kw)
    return JConfig(dtype=jdt, **kw), TConfig(dtype=tdt, **kw)


class TestKernelsAgainstReference:
    SHAPES = [(37, 100, 8), (64, 256, 16), (9, 130, 8)]

    @pytest.mark.parametrize("M,N,bm", SHAPES)
    @pytest.mark.parametrize("dname", list(DTYPES))
    def test_colsum(self, M, N, bm, dname):
        jdt, tdt = DTYPES[dname]
        A, _, _ = problem(M, N, M + N)
        want = juf.colsum(jnp.asarray(pad_rows(A, bm), jdt), block_m=bm,
                          interpret=True)
        At = torch.tensor(A).to(tdt)
        got = tuf.colsum(At)
        assert got.shape == (N,) and got.dtype == torch.float32
        close(got, want, dname)
        np.testing.assert_allclose(got.numpy(), tref.colsum_ref(At).numpy(),
                                   **F32_CALL)

    @pytest.mark.parametrize("M,N,bm", SHAPES)
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("fi", [1.0, 0.9])
    def test_fused_iteration(self, M, N, bm, dname, fi):
        jdt, tdt = DTYPES[dname]
        A, a, _ = problem(M, N, M * N)
        fcol = np.random.default_rng(M).uniform(0.5, 1.5, N).astype(
            np.float32)
        Aj, csj = juf.fused_iteration(
            jnp.asarray(pad_rows(A, bm), jdt), jnp.asarray(fcol),
            jnp.asarray(pad_rows(a, bm)), fi=fi, block_m=bm, interpret=True)
        At = torch.tensor(A).to(tdt)
        out, cs = tuf.fused_iteration(At, torch.tensor(fcol),
                                      torch.tensor(a), fi=fi)
        assert out is At and out.dtype == tdt     # in place
        close(out, np.asarray(Aj)[:M], dname)
        close(cs, csj, dname)

    def test_oracle_and_counters(self):
        A, a, _ = problem(12, 40, 3)
        fcol = torch.full((40,), 1.1)
        want, cs_ref = tref.fused_iteration_ref(torch.tensor(A), fcol,
                                                torch.tensor(a), fi=0.9)
        tuf.reset_counts()
        got, cs = tuf.fused_iteration(torch.tensor(A), fcol, torch.tensor(a),
                                      fi=0.9)
        assert torch.equal(got, want) and torch.equal(cs, cs_ref)
        assert tuf.PLAIN_CALLS == {"colsum": 0, "fused_iteration": 1}
        assert tuf.LAUNCHES == {"colsum": 0, "fused_iteration": 0}

    def test_wrappers_check_their_arguments(self):
        A = torch.ones(4, 8)
        with pytest.raises(ValueError, match="M, N"):
            tuf.colsum(torch.ones(2, 4, 8))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tuf.colsum(A.double())
        with pytest.raises(ValueError, match="factor_col"):
            tuf.fused_iteration(A, torch.ones(7), torch.ones(4), fi=1.0)
        with pytest.raises(ValueError, match="no kernel"):
            tuf.colsum(A.to("meta"))

    @pytest.mark.parametrize("M,N", [(4096, 4096), (1, 77), (1000, 1500)])
    @pytest.mark.parametrize("s", [4, 2])
    def test_colsum_plan_covers_the_rows(self, M, N, s):
        plan = ub.plan_colsum(1, M, N, s)
        assert plan.ctas * plan.rows_per_cta >= M
        assert (plan.ctas - 1) * plan.rows_per_cta < M
        if N % (16 // s) == 0:
            assert plan.vec == 16 // s
        tiles = -(-(N // plan.vec) // 256)
        if M >= 4 * 132:
            # the grid fills the card from one problem: about
            # COLSUM_BLOCKS_PER_SM blocks on each SM
            want = ub.COLSUM_BLOCKS_PER_SM * 132
            assert 0.9 * want <= plan.ctas * tiles <= 1.1 * want

    @pytest.mark.parametrize("B,M,N,s", [(1, 4096, 4096, 4),
                                         (1, 4096, 4096, 2),
                                         (8, 2048, 2048, 4),
                                         (1, 8192, 8192, 4), (1, 37, 100, 4)])
    def test_streamed_plan_is_one_wave(self, B, M, N, s):
        """Kernels b, d, e: the grid fits the card at once, and a problem
        large enough fills it."""
        p = ub.plan_for(B, M, N, s)
        per_sm = min(ub.MAX_BLOCKS_PER_SM,
                     ub.SM_SMEM // (p.smem_bytes + ub.BLOCK_SMEM_RESERVED))
        slots = ub.NUM_SMS * per_sm
        assert B * p.ctas <= slots
        if B * M >= 2 * slots * p.block_m:
            assert B * p.ctas >= slots // 2


class TestSolveFused:
    @pytest.mark.parametrize("dname", list(DTYPES))
    def test_default_impl_matches_reference(self, dname):
        jc, tc = cfgs(dname)
        K, a, b = problem(45, 150, 5)
        Pj, csj = jops.solve_fused(jnp.asarray(K), jnp.asarray(a),
                                   jnp.asarray(b), jc, interpret=True)
        Pt, cst = tops.solve_fused(K, a, b, tc, device="cpu")
        assert Pt.shape == (45, 150) and Pt.dtype == DTYPES[dname][1]
        close(Pt, Pj, dname, call=False)
        close(cst, csj, dname, call=False)

    def test_default_impl_ignores_tol(self):
        """impl=None runs exactly num_iters iterations, tol or not
        (reference ops.py:500-522)."""
        _, tc = cfgs(num_iters=12)
        _, tc_tol = cfgs(num_iters=12, tol=1e-1)
        K, a, b = problem(20, 64, 6)
        P0, _ = tops.solve_fused(K, a, b, tc, device="cpu")
        P1, _ = tops.solve_fused(K, a, b, tc_tol, device="cpu")
        assert torch.equal(P0, P1)
        Pref, st = sinkhorn_uot_fused(torch.tensor(K), torch.tensor(a),
                                      torch.tensor(b), tc_tol)
        assert st["iters"] < 12      # tol would have stopped the plain solver

    @pytest.mark.parametrize("tol", [None, 1e-4])
    def test_auto_fitting_routes_resident_and_matches_reference(self, tol):
        jc, tc = cfgs(num_iters=200, tol=tol)
        K, a, b = problem(40, 200, 7, peak=3.0)
        Pj, csj = jops.solve_fused(jnp.asarray(K), jnp.asarray(a),
                                   jnp.asarray(b), jc, impl="auto",
                                   interpret=True)
        with tops.dispatch_counters() as counts:
            Pt, cst = tops.solve_fused(K, a, b, tc, impl="auto",
                                       device="cpu")
        assert counts == {"resident": 1, "streamed": 0}
        close(Pt, Pj, "float32", call=False)
        close(cst, csj, "float32", call=False)
        Pr, _ = tops.solve_fused(K, a, b, tc, impl="resident", device="cpu")
        assert torch.equal(Pr, Pt)

    def test_auto_over_budget_streams_with_tol(self):
        """256x256 is over the Hopper budget (but inside the TPU's): the
        port streams it through the batched path at B=1 and still honours
        tol, so it agrees with the reference's resident answer and count."""
        jc, tc = cfgs(num_iters=300, tol=1e-4)
        K, a, b = problem(256, 256, 8, peak=2.0)
        assert not tops.resident_fits(256, 256, tc)
        Pj, _, itj, _ = jops.solve_fused_resident(
            jnp.asarray(K), jnp.asarray(a), jnp.asarray(b), jc,
            impl="kernel", interpret=True)
        with tops.dispatch_counters() as counts:
            Pt, _ = tops.solve_fused(K, a, b, tc, impl="auto", device="cpu")
        assert counts == {"resident": 0, "streamed": 1}
        close(Pt, Pj, "float32", call=False)
        _, st = sinkhorn_uot_fused(torch.tensor(K), torch.tensor(a),
                                   torch.tensor(b), tc)
        assert st["iters"] == int(itj) < 300

    def test_resident_over_budget_and_later_slices_raise(self):
        _, tc = cfgs()
        K, a, b = problem(256, 256, 9)
        with pytest.raises(ValueError, match="resident budget"):
            tops.solve_fused(K, a, b, tc, impl="resident", device="cpu")
        with pytest.raises(TypeError, match="Geometry"):
            tops.solve_fused(None, a, b, tc, geometry=object(), device="cpu")
        with pytest.raises(ValueError, match="impl"):
            tops.solve_fused(K, a, b, tc, impl="jnp", device="cpu")

    def test_inputs_are_not_written(self):
        _, tc = cfgs()
        K, a, b = problem(8, 16, 10)
        K0, Kt = K.copy(), torch.tensor(K)
        tops.solve_fused(K, a, b, tc, device="cpu")
        tops.solve_fused(Kt, a, b, tc, device="cpu")
        tops.solve_fused(Kt, a, b, tc, impl="auto", device="cpu")
        np.testing.assert_array_equal(K, K0)
        np.testing.assert_array_equal(Kt.numpy(), K0)

