"""PyTorch port, kernels c, d, e and the batched / bucketed solvers.

The same numpy inputs go through the JAX reference — its Pallas kernels in
interpret mode (``interpret=True`` / ``impl='kernel', interpret=True``), as
the reference's own tests run them on the CPU — and through the port,
whose wrappers take their plain PyTorch versions for CPU tensors.

Tolerances (summation order differs between the two):
  * fp32 per kernel call: rtol 1e-5, atol 1e-7;
  * fp32 whole solves: relative 1e-4;
  * bf16: the reference's bars, 5e-2 pointwise and 1e-2 mass
    (tests/test_bf16_accumulation.py).
Inside the port, a frozen lane of kernel e is held bitwise.

Tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card; they skip where there is no card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import UOTConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import uot_batched as jub
from repro_torch.core import UOTConfig as TConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import uot_batched as tub

F32_CALL = dict(rtol=1e-5, atol=1e-7)
RTOL_SOLVE = 1e-4
BF16_POINT, BF16_MASS = 5e-2, 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rand(shape, seed, lo=0.1, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def stack(B, M, N, seed, reg=0.1):
    rng = np.random.default_rng(seed)
    C = rng.uniform(0, 1, (B, M, N)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, (B, M)).astype(np.float32)
    b = rng.uniform(0.5, 1.5, (B, N)).astype(np.float32)
    a = a / a.sum(1, keepdims=True)
    b = b / b.sum(1, keepdims=True) * 1.2
    K = np.exp(-C / reg) * (a[:, :, None] * b[:, None, :])
    return K.astype(np.float32), a, b


def f32(x):
    return np.asarray(torch.as_tensor(x).float()) if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, dtype_name, *, call=True):
    got, want = f32(got), f32(want)
    if dtype_name == "bfloat16":
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= BF16_POINT * scale
        assert abs(got.sum() - want.sum()) <= BF16_MASS * abs(want.sum())
    elif call:
        np.testing.assert_allclose(got, want, **F32_CALL)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= RTOL_SOLVE, err


def tstore(x, tdt):
    return torch.tensor(x).to(tdt)


class TestKernelsAgainstReference:
    SHAPES = [(2, 16, 128, 8), (3, 32, 256, 16)]

    @pytest.mark.parametrize("B,M,N,bm", SHAPES)
    @pytest.mark.parametrize("dname", list(DTYPES))
    def test_colsum(self, B, M, N, bm, dname):
        jdt, tdt = DTYPES[dname]
        A = rand((B, M, N), B + M)
        want = jub.batched_colsum(jnp.asarray(A, jdt), block_m=bm,
                                  interpret=True)
        got = tub.batched_colsum(tstore(A, tdt))
        close(got, want, dname)

    @pytest.mark.parametrize("B,M,N,bm", SHAPES)
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("fi", [0.9, 1.0])
    def test_fused_iteration(self, B, M, N, bm, dname, fi):
        jdt, tdt = DTYPES[dname]
        A, fcol, a = rand((B, M, N), M), rand((B, N), 1), rand((B, M), 2)
        out_j, cs_j = jub.batched_fused_iteration(
            jnp.asarray(A, jdt), jnp.asarray(fcol), jnp.asarray(a), fi=fi,
            block_m=bm, interpret=True)
        At = tstore(A, tdt)
        out_t, cs_t = tub.batched_fused_iteration(
            At, torch.tensor(fcol), torch.tensor(a), fi=fi)
        assert out_t.data_ptr() == At.data_ptr()      # in place
        close(out_t, out_j, dname)
        close(cs_t, cs_j, dname)

    @pytest.mark.parametrize("B,M,N,bm", SHAPES)
    @pytest.mark.parametrize("dname", list(DTYPES))
    def test_fused_iteration_frow_frozen_lanes(self, B, M, N, bm, dname):
        jdt, tdt = DTYPES[dname]
        A, fcol, a = rand((B, M, N), M), rand((B, N), 3), rand((B, M), 4)
        carried = rand((B, N), 5)
        mask = np.arange(B) % 2 == 0
        out_j, cs_j, frow_j = jub.batched_fused_iteration_frow(
            jnp.asarray(A, jdt), jnp.asarray(fcol), jnp.asarray(a),
            jnp.asarray(mask), fi=0.9, block_m=bm, interpret=True)
        At, cst = tstore(A, tdt), torch.tensor(carried)
        A0, cs0 = At.clone(), cst.clone()
        out_t, cs_t, frow_t = tub.batched_fused_iteration_frow(
            At, torch.tensor(fcol), torch.tensor(a), torch.tensor(mask), cst,
            fi=0.9)
        live = torch.tensor(mask)
        close(out_t, out_j, dname)             # frozen tiles: input == input
        close(cs_t[live], np.asarray(cs_j)[mask], dname)
        close(frow_t[live], np.asarray(frow_j)[mask], dname)
        # frozen lanes: tile and carried column sums untouched, bitwise
        assert torch.equal(out_t[~live], A0[~live])
        assert torch.equal(cs_t[~live], cs0[~live])

    def test_oracles_agree_with_plain_versions(self):
        A, fcol, a = rand((2, 8, 24), 6), rand((2, 24), 7), rand((2, 8), 8)
        out, cs = tref.batched_fused_iteration_ref(
            torch.tensor(A), torch.tensor(fcol), torch.tensor(a), fi=0.9)
        At = torch.tensor(A)
        tub.batched_fused_iteration(At, torch.tensor(fcol), torch.tensor(a),
                                    fi=0.9)
        np.testing.assert_allclose(At.numpy(), out.numpy(), **F32_CALL)
        np.testing.assert_allclose(tref.batched_colsum_ref(torch.tensor(A)),
                                   tub.batched_colsum(torch.tensor(A)),
                                   **F32_CALL)

    def test_wrappers_check_their_arguments(self):
        A = torch.ones(2, 4, 8)
        with pytest.raises(ValueError, match="factor_col"):
            tub.batched_fused_iteration(A, torch.ones(2, 7), torch.ones(2, 4),
                                        fi=1.0)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tub.batched_colsum(A.double())
        with pytest.raises(ValueError, match="mask"):
            tub.batched_fused_iteration_frow(
                A, torch.ones(2, 8), torch.ones(2, 4), torch.ones(2),
                torch.ones(2, 8), fi=1.0)


class TestPlan:
    @pytest.mark.parametrize("B,M,N,s", [
        (8, 2048, 2048, 4), (8, 2048, 2048, 2), (1, 4096, 4096, 4),
        (8, 1000, 1500, 4), (3, 257, 16384, 4), (2, 33, 77, 2), (1, 1, 1, 4)])
    def test_plan_covers_the_rows(self, B, M, N, s):
        p = tub.plan_for(B, M, N, s)
        assert p.rows_per_cta % p.block_m == 0
        assert p.ctas * p.rows_per_cta >= M > (p.ctas - 1) * p.rows_per_cta
        assert p.smem_bytes <= tub.SMEM_LIMIT
        assert p.vec in (1, 16 // s) and N % p.vec == 0
        c = tub.plan_colsum(B, M, N, s)
        assert c.ctas * c.rows_per_cta >= M > (c.ctas - 1) * c.rows_per_cta

    def test_variants_and_limits(self):
        assert tub.plan_for(8, 2048, 2048, 4).one_pass
        assert not tub.plan_for(3, 257, 16384, 4).one_pass
        assert tub.plan_for(3, 257, 16384, 2).one_pass is False
        assert tub.plan_for(3, 257, 8192, 2).one_pass
        with pytest.raises(ValueError, match="too wide"):
            tub.plan_for(1, 8, 1 << 16, 4)
        assert tub.pick_block_m(2048, 2048, 4) == 8
        assert tub.pick_block_m(4, 2048, 4) == 8   # capped near M


def test_pad_helpers_match_reference():
    x, v = rand((2, 5, 7), 3), rand((2, 5), 4)
    np.testing.assert_array_equal(
        tops.pad_to(torch.tensor(x), 4, 8).numpy(),
        np.asarray(jops.pad_to(jnp.asarray(x), 4, 8)))
    np.testing.assert_array_equal(
        tops.pad_vec(torch.tensor(v), 8).numpy(),
        np.asarray(jops.pad_vec(jnp.asarray(v), 8)))
    assert tops.pad_to(torch.tensor(x[0]), 5, 7).shape == (5, 7)


class TestSolveFusedBatched:
    @pytest.mark.parametrize("tol", [None, 1e-5])
    @pytest.mark.parametrize("dname", list(DTYPES))
    def test_matches_reference_on_ragged_shape(self, tol, dname):
        jdt, tdt = DTYPES[dname]
        K, a, b = stack(3, 40, 100, 0)
        jc = JConfig(reg=0.1, reg_m=1.0, num_iters=25, tol=tol, dtype=jdt)
        tc = TConfig(reg=0.1, reg_m=1.0, num_iters=25, tol=tol, dtype=tdt)
        Pj, csj = jops.solve_fused_batched(
            jnp.asarray(K), jnp.asarray(a), jnp.asarray(b), jc, block_m=8,
            interpret=True, impl="kernel")
        Pt, cst = tops.solve_fused_batched(K, a, b, tc, device="cpu")
        assert Pt.shape == (3, 40, 100) and Pt.dtype == tdt
        close(Pt, Pj, dname, call=False)
        close(cst, csj, dname, call=False)

    def test_inputs_are_not_written(self):
        K, a, b = stack(2, 8, 16, 1)
        K0 = K.copy()
        Kt = torch.tensor(K)
        tops.solve_fused_batched(Kt, a, b, TConfig(num_iters=3),
                                 device="cpu")
        tops.solve_fused_batched(K, a, b, TConfig(num_iters=3), device="cpu")
        np.testing.assert_array_equal(K, K0)
        np.testing.assert_array_equal(Kt.numpy(), K0)

    def test_later_slices_raise(self):
        """impl='auto' / 'resident' are ported (kernel f): they route
        through the dispatch counters and match the reference. geometry=
        is still a later slice."""
        K, a, b = stack(2, 24, 100, 2)
        kw = dict(reg=0.1, reg_m=1.0, num_iters=25, tol=1e-4)
        Pj, csj = jops.solve_fused_batched(
            jnp.asarray(K), jnp.asarray(a), jnp.asarray(b), JConfig(**kw),
            impl="auto", interpret=True)
        for impl, routed in (("auto", {"resident": 1, "streamed": 0}),
                             ("resident", {"resident": 0, "streamed": 0})):
            with tops.dispatch_counters():
                Pt, cst = tops.solve_fused_batched(K, a, b, TConfig(**kw),
                                                   device="cpu", impl=impl)
                assert tops.dispatch_stats() == routed
            close(Pt, Pj, "float32", call=False)
            close(cst, csj, "float32", call=False)
        with pytest.raises(NotImplementedError, match="geometry"):
            tops.solve_fused_batched(None, a, b, TConfig(), device="cpu",
                                     geometry=object())
        with pytest.raises(ValueError, match="impl"):
            tops.solve_fused_batched(K, a, b, TConfig(), device="cpu",
                                     impl="jnp")


class TestBucketed:
    def test_ragged_list_matches_reference(self):
        shapes = [(10, 60), (30, 120), (12, 50), (64, 128), (33, 129)]
        probs = [tuple(x[0] for x in stack(1, m, n, 10 + i))
                 for i, (m, n) in enumerate(shapes)]
        jc = JConfig(reg=0.1, reg_m=1.0, num_iters=20, tol=1e-6)
        tc = TConfig(reg=0.1, reg_m=1.0, num_iters=20, tol=1e-6)
        want = jops.solve_fused_bucketed(
            [tuple(jnp.asarray(x) for x in p) for p in probs], jc,
            interpret=True, impl="kernel", max_batch=2)
        tops.reset_bucketed_cache_stats()
        got = tops.solve_fused_bucketed(probs, tc, max_batch=2,
                                        device="cpu")
        for (Pj, csj), (Pt, cst), (m, n) in zip(want, got, shapes):
            assert Pt.shape == (m, n) and Pt.dtype == np.float32
            close(Pt, Pj, "float32", call=False)
            close(cst, csj, "float32", call=False)
        stats = tops.bucketed_cache_stats()
        assert stats["hits"] + stats["misses"] == 3   # one per chunk
        assert tops.canonical_batch(3, 64) == 4
        assert tops.canonical_batch(100, 64) == 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("B,M,N", [(4, 300, 1500), (2, 64, 77),
                                   (2, 9, 16384)])
def test_cuda_kernels_match_plain_versions(cuda, dname, B, M, N):
    _, tdt = DTYPES[dname]
    g = torch.Generator(device=cuda).manual_seed(B + M + N)
    A = (torch.rand((B, M, N), generator=g, device=cuda) + 0.1).to(tdt)
    fcol = torch.rand((B, N), generator=g, device=cuda) + 0.5
    a = torch.rand((B, M), generator=g, device=cuda) + 0.5
    mask = torch.arange(B, device=cuda) % 2 == 0
    close(tub.batched_colsum(A).cpu(), tub.batched_colsum_plain(A).cpu(),
          dname)
    A1, A2 = A.clone(), A.clone()
    _, c1 = tub.batched_fused_iteration(A1, fcol, a, fi=0.9)
    _, c2 = tub.batched_fused_iteration_plain(A2, fcol, a, fi=0.9)
    close(A1.cpu(), A2.cpu(), dname)
    close(c1.cpu(), c2.cpu(), dname)
    A3, A4 = A.clone(), A.clone()
    cs3, cs4 = torch.zeros(B, N, device=cuda), torch.zeros(B, N, device=cuda)
    _, _, f3 = tub.batched_fused_iteration_frow(A3, fcol, a, mask, cs3,
                                                fi=0.9)
    _, _, f4 = tub.batched_fused_iteration_frow_plain(A4, fcol, a, mask, cs4,
                                                      fi=0.9)
    close(A3.cpu(), A4.cpu(), dname)
    close(f3[mask].cpu(), f4[mask].cpu(), dname)
    assert torch.equal(A3[~mask], A[~mask])
    assert torch.equal(cs3[~mask], torch.zeros_like(cs3[~mask]))
    # the same launch twice gives the same bits
    A5 = A.clone()
    _, c5 = tub.batched_fused_iteration(A5, fcol, a, fi=0.9)
    assert torch.equal(A5, A1) and torch.equal(c5, c1)
