"""PyTorch port, the u/v potential form: ``core.sinkhorn_uv``, kernels l,
m, n and o (plain versions) and ``ops.solve_uv`` / ``solve_uv_batched``.

The same numpy inputs go through the JAX reference — its Pallas kernels in
interpret mode, as the reference's own tests run them on the CPU — and
through the port, whose wrappers take their plain PyTorch versions for CPU
tensors. The reference kernels want M padded to a multiple of the row
block: zero rows with ``a = 0`` give ``u = 1`` there (``_safe_pow(0, 0)``)
and add nothing to ``K^T u``, so the port gets the ragged shape and the
reference the padded one, and only ``u[:M]`` is compared. ``v`` is seeded
randomly in the kernel tests, so a ``K^T u`` that wrongly took the
v-scaled tile would show.

Tolerances (the two sides sum in different orders):
  * one kernel call, fp32 results (u, K^T u, and P in fp32): rtol 1e-5,
    atol 1e-7; a bf16 coupling one bf16 rounding (2**-7) per entry;
  * whole solves: u, v rtol 3e-5 and P rtol 3e-4 (atol 1e-8 for P), the
    reference's own bars (tests/test_kernels.py:147-154);
  * a bf16 K is upcast exactly on both sides, so its results are held to
    the fp32 bars and, in addition, to the reference's bf16 bars (5e-2
    pointwise, 1e-2 mass);
  * the tol loop of ``sinkhorn_uot_uv``: iteration counts equal (the
    problems are chosen so the drift clears tol by a margin).

The card's tests of kernels l-o are in ``test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import UOTConfig as JConfig
from repro.core import sinkhorn_uv as juv
from repro.geometry import GridGeometry as JGrid
from repro.geometry import PointCloudGeometry as JPC
from repro.kernels import ops as jops
from repro.kernels import uot_batched as jub
from repro.kernels import uot_uv_fused as juf
from repro_torch import convert
from repro_torch.core import UOTConfig as TConfig
from repro_torch.core import health as thealth
from repro_torch.core import log_domain as tlog
from repro_torch.core import sinkhorn_uv as tuv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import uot_batched as tub
from repro_torch.kernels import uot_uv_fused as tuf

CALL = dict(rtol=1e-5, atol=1e-7)
UV_RTOL = 3e-5
P_SOLVE = dict(rtol=3e-4, atol=1e-8)
BF16_ULP = 2.0 ** -7
BF16_POINT, BF16_MASS = 5e-2, 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = "cpu"


def problem(M, N, seed, reg=0.1, peak=1.0, mass=1.2):
    rng = np.random.default_rng(seed)
    C = rng.uniform(0, 1, (M, N)).astype(np.float32) * peak
    a = rng.uniform(0.5, 1.5, M).astype(np.float32)
    b = rng.uniform(0.5, 1.5, N).astype(np.float32)
    a, b = a / a.sum(), b / b.sum() * mass
    return (np.exp(-C / reg) * (a[:, None] * b[None, :])).astype(
        np.float32), a, b


def stack(B, M, N, seed, reg=0.1):
    probs = [problem(M, N, seed + k, reg=reg, peak=1.0 + k) for k in
             range(B)]
    return tuple(np.stack([p[i] for p in probs]) for i in range(3))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def pad_rows(x, bm, axis=0):
    p = (-x.shape[axis]) % bm
    if not p:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, p)
    return np.pad(x, pads)


def bf16_round(x):
    """numpy fp32 -> the bf16 values it rounds to, back as fp32."""
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


def held_bf16(got, want):
    got, want = f32(got), f32(want)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_POINT * scale
    assert abs(got.sum() - want.sum()) <= BF16_MASS * abs(want.sum())


def cfgs(dname="float32", **kw):
    jdt, tdt = DTYPES[dname]
    kw = dict(dict(reg=0.1, reg_m=1.0, num_iters=40), **kw)
    return JConfig(dtype=jdt, **kw), TConfig(dtype=tdt, **kw)


def fields(g):
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


class TestKernelsAgainstReference:
    SHAPES = [(37, 100, 8), (64, 256, 16), (9, 130, 8)]

    @pytest.mark.parametrize("M,N,bm", SHAPES)
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("fi", [1.0, 0.9])
    def test_uv_iteration(self, M, N, bm, dname, fi):
        jdt, tdt = DTYPES[dname]
        K, a, _ = problem(M, N, M * N)
        v = np.random.default_rng(M).uniform(0.5, 1.5, N).astype(np.float32)
        uj, ktuj = juf.uv_iteration(
            jnp.asarray(pad_rows(K, bm), jdt), jnp.asarray(v),
            jnp.asarray(pad_rows(a, bm)), fi=fi, block_m=bm, interpret=True)
        assert np.all(np.asarray(uj)[M:] == 1.0)   # padded rows: u = 1
        Kt = torch.tensor(K).to(tdt)
        u, ktu = tuf.uv_iteration(Kt, torch.tensor(v), torch.tensor(a),
                                  fi=fi)
        assert u.shape == (M,) and ktu.shape == (N,)
        assert u.dtype == ktu.dtype == torch.float32
        np.testing.assert_allclose(f32(u), f32(uj)[:M], **CALL)
        np.testing.assert_allclose(f32(ktu), f32(ktuj), **CALL)
        u_r, ktu_r = tref.uv_iteration_ref(Kt, torch.tensor(v),
                                           torch.tensor(a), fi=fi)
        np.testing.assert_allclose(f32(u), f32(u_r), **CALL)
        np.testing.assert_allclose(f32(ktu), f32(ktu_r), **CALL)

    @pytest.mark.parametrize("M,N,bm", SHAPES)
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("out", list(DTYPES))
    def test_materialize_coupling(self, M, N, bm, dname, out):
        jdt, tdt = DTYPES[dname]
        jout, tout = DTYPES[out]
        K, a, b = problem(M, N, M + 2 * N)
        rng = np.random.default_rng(N)
        u = rng.uniform(0.5, 20, M).astype(np.float32)
        v = rng.uniform(0.5, 20, N).astype(np.float32)
        Pj = juf.materialize_coupling(
            jnp.asarray(pad_rows(K, bm), jdt), jnp.asarray(pad_rows(u, bm)),
            jnp.asarray(v), block_m=bm, interpret=True, out_dtype=jout)
        P = tuf.materialize_coupling(torch.tensor(K).to(tdt),
                                     torch.tensor(u), torch.tensor(v),
                                     out_dtype=tout)
        assert P.shape == (M, N) and P.dtype == tout
        want = f32(Pj)[:M]
        if out == "float32":
            np.testing.assert_allclose(f32(P), want, **CALL)
        else:
            np.testing.assert_allclose(f32(P), want, rtol=BF16_ULP, atol=0)
        # the plain version is the oracle's products, rounded once
        oracle = f32(tref.materialize_coupling_ref(
            torch.tensor(K).to(tdt), torch.tensor(u), torch.tensor(v)))
        np.testing.assert_array_equal(
            f32(P), oracle if out == "float32" else bf16_round(oracle))

    @pytest.mark.parametrize("B,M,N,bm", [(3, 37, 100, 8), (2, 64, 129, 16)])
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("fi", [1.0, 0.9])
    def test_batched_uv_iteration(self, B, M, N, bm, dname, fi):
        jdt, tdt = DTYPES[dname]
        K, a, _ = stack(B, M, N, B * M)
        v = np.random.default_rng(N).uniform(0.5, 1.5, (B, N)).astype(
            np.float32)
        uj, ktuj = jub.batched_uv_iteration(
            jnp.asarray(pad_rows(K, bm, 1), jdt), jnp.asarray(v),
            jnp.asarray(pad_rows(a, bm, 1)), fi=fi, block_m=bm,
            interpret=True)
        Kt = torch.tensor(K).to(tdt)
        u, ktu = tub.batched_uv_iteration(Kt, torch.tensor(v),
                                          torch.tensor(a), fi=fi)
        assert u.shape == (B, M) and ktu.shape == (B, N)
        np.testing.assert_allclose(f32(u), f32(uj)[:, :M], **CALL)
        np.testing.assert_allclose(f32(ktu), f32(ktuj), **CALL)
        u_r, ktu_r = tref.batched_uv_iteration_ref(Kt, torch.tensor(v),
                                                   torch.tensor(a), fi=fi)
        np.testing.assert_allclose(f32(ktu), f32(ktu_r), **CALL)

    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("out", list(DTYPES))
    def test_batched_materialize_coupling(self, dname, out):
        jdt, tdt = DTYPES[dname]
        jout, tout = DTYPES[out]
        B, M, N, bm = 3, 37, 100, 8
        K, _, _ = stack(B, M, N, 11)
        rng = np.random.default_rng(12)
        u = rng.uniform(0.5, 20, (B, M)).astype(np.float32)
        v = rng.uniform(0.5, 20, (B, N)).astype(np.float32)
        Pj = jub.batched_materialize_coupling(
            jnp.asarray(pad_rows(K, bm, 1), jdt),
            jnp.asarray(pad_rows(u, bm, 1)), jnp.asarray(v), block_m=bm,
            interpret=True, out_dtype=jout)
        P = tub.batched_materialize_coupling(
            torch.tensor(K).to(tdt), torch.tensor(u), torch.tensor(v),
            out_dtype=tout)
        assert P.shape == (B, M, N) and P.dtype == tout
        rtol = CALL["rtol"] if out == "float32" else BF16_ULP
        np.testing.assert_allclose(f32(P), f32(Pj)[:, :M], rtol=rtol,
                                   atol=CALL["atol"] if out == "float32"
                                   else 0)
        oracle = f32(tref.batched_materialize_coupling_ref(
            torch.tensor(K).to(tdt), torch.tensor(u), torch.tensor(v)))
        np.testing.assert_array_equal(
            f32(P), oracle if out == "float32" else bf16_round(oracle))

    def test_counters(self):
        K, a, _ = problem(12, 40, 3)
        Kt, at, v = torch.tensor(K), torch.tensor(a), torch.ones(40)
        for mod in (tub, tuf):
            mod.reset_counts()
        u, _ = tuf.uv_iteration(Kt, v, at, fi=0.9)
        tuf.materialize_coupling(Kt, u, v)
        tub.batched_uv_iteration(Kt[None], v[None], at[None], fi=0.9)
        tub.batched_materialize_coupling(Kt[None], u[None], v[None])
        assert tuf.PLAIN_CALLS == {"uv_iteration": 1,
                                   "materialize_coupling": 1}
        assert tuf.LAUNCHES == {"uv_iteration": 0, "materialize_coupling": 0}
        assert tub.PLAIN_CALLS["batched_uv_iteration"] == 1
        assert tub.PLAIN_CALLS["batched_materialize_coupling"] == 1
        assert not any(tub.LAUNCHES.values())
        assert set(tub.PLAIN_CALLS) == set(tub.LAUNCHES)

    def test_wrappers_check_their_arguments(self):
        K = torch.ones(4, 8)
        with pytest.raises(ValueError, match="M, N"):
            tuf.uv_iteration(torch.ones(2, 4, 8), torch.ones(8),
                             torch.ones(4), fi=1.0)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tuf.uv_iteration(K.double(), torch.ones(8), torch.ones(4),
                             fi=1.0)
        with pytest.raises(ValueError, match="v must be"):
            tuf.uv_iteration(K, torch.ones(7), torch.ones(4), fi=1.0)
        with pytest.raises(ValueError, match="a must be"):
            tub.batched_uv_iteration(K[None], torch.ones(1, 8),
                                     torch.ones(1, 5), fi=1.0)
        with pytest.raises(ValueError, match="B, M, N"):
            tub.batched_materialize_coupling(K, torch.ones(4),
                                             torch.ones(8))
        with pytest.raises(ValueError, match="u must be"):
            tuf.materialize_coupling(K, torch.ones(4, dtype=torch.float64),
                                     torch.ones(8))
        with pytest.raises(TypeError, match="out_dtype"):
            tuf.materialize_coupling(K, torch.ones(4), torch.ones(8),
                                     out_dtype=torch.float16)
        with pytest.raises(ValueError, match="no kernel"):
            tuf.uv_iteration(K.to("meta"), torch.ones(8, device="meta"),
                             torch.ones(4, device="meta"), fi=1.0)


class TestSolveUV:
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("reg_m", [1.0, float("inf")])
    def test_solve_uv_matches_reference(self, dname, reg_m):
        jdt, tdt = DTYPES[dname]
        jc, tc = cfgs(reg_m=reg_m, num_iters=60)
        K, a, b = problem(100, 77, 0, mass=1.0 if reg_m == float("inf")
                          else 1.2)
        Pj, (uj, vj) = jops.solve_uv(jnp.asarray(K, jdt), jnp.asarray(a),
                                     jnp.asarray(b), jc, block_m=16,
                                     interpret=True)
        P, (u, v) = tops.solve_uv(torch.tensor(K).to(tdt), a, b, tc,
                                  device=CPU)
        assert P.shape == (100, 77) and P.dtype == torch.float32
        assert u.shape == (100,) and v.shape == (77,)
        np.testing.assert_allclose(f32(u), f32(uj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(v), f32(vj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(P), f32(Pj), **P_SOLVE)
        if dname == "bfloat16":
            held_bf16(P, Pj)

    def test_materialize_false_and_zero_iterations(self):
        jc, tc = cfgs(num_iters=0)
        K, a, b = problem(30, 50, 1)
        P, (u, v) = tops.solve_uv(K, a, b, tc, materialize=False,
                                  device=CPU)
        assert P is None
        _, (uj, vj) = jops.solve_uv(jnp.asarray(K), jnp.asarray(a),
                                    jnp.asarray(b), jc, interpret=True,
                                    materialize=False)
        assert torch.equal(v, torch.ones(50))
        np.testing.assert_allclose(f32(u), f32(uj), rtol=UV_RTOL)

    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("impl", ["kernel", "jnp"])
    def test_solve_uv_batched_matches_reference(self, dname, impl):
        jdt, tdt = DTYPES[dname]
        jc, tc = cfgs(num_iters=50)
        K, a, b = stack(3, 45, 70, 21)
        Pj, (uj, vj) = jops.solve_uv_batched(
            jnp.asarray(K, jdt), jnp.asarray(a), jnp.asarray(b), jc,
            block_m=16, interpret=True, impl=impl)
        P, (u, v) = tops.solve_uv_batched(
            torch.tensor(K).to(tdt), a, b, tc, device=CPU,
            impl=None if impl == "jnp" else impl)
        assert P.shape == (3, 45, 70) and P.dtype == torch.float32
        np.testing.assert_allclose(f32(u), f32(uj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(v), f32(vj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(P), f32(Pj), **P_SOLVE)
        if dname == "bfloat16":
            held_bf16(P, Pj)
        _, (u_n, v_n) = tops.solve_uv_batched(
            torch.tensor(K).to(tdt), a, b, tc, device=CPU,
            materialize=False)
        assert torch.equal(u_n, u) and torch.equal(v_n, v)

    def test_batched_equals_per_problem(self):
        _, tc = cfgs(num_iters=30)
        K, a, b = stack(2, 20, 33, 5)
        P, (u, v) = tops.solve_uv_batched(K, a, b, tc, device=CPU)
        for i in range(2):
            Pi, (ui, vi) = tops.solve_uv(K[i], a[i], b[i], tc, device=CPU)
            np.testing.assert_allclose(f32(Pi), f32(P[i]), rtol=1e-6)
            np.testing.assert_allclose(f32(vi), f32(v[i]), rtol=1e-6)

    def test_solve_uv_holds_the_plain_core_solver(self):
        """ops.solve_uv has the iterates of core.sinkhorn_uot_uv_fused:
        v equal, and u one half-iteration further (the reference's extra
        pass for the final u, ops.py:1467-1469)."""
        _, tc = cfgs(num_iters=25)
        K, a, b = (torch.tensor(x) for x in problem(50, 64, 3))
        P, (u, v) = tops.solve_uv(K, a, b, tc, device=CPU)
        _, (u_c, v_c), st = tuv.sinkhorn_uot_uv_fused(K, a, b, tc)
        assert st["iters"] == 25
        np.testing.assert_allclose(f32(v), f32(v_c), rtol=UV_RTOL)
        u_next, _ = tuv.uv_fused_iteration(K, v_c, a, b, tc.fi)
        np.testing.assert_allclose(f32(u), f32(u_next), rtol=UV_RTOL)
        np.testing.assert_allclose(
            f32(P), f32(u_next[:, None] * K * v_c[None, :]), **P_SOLVE)

    def test_impl_and_shape_errors(self):
        _, tc = cfgs()
        K, a, b = stack(2, 8, 16, 1)
        for impl in ("jnp", "resident", "auto"):
            with pytest.raises(ValueError, match="no resident tier"):
                tops.solve_uv_batched(K, a, b, tc, impl=impl, device=CPU)
        with pytest.raises(ValueError, match="B, M, N"):
            tops.solve_uv_batched(K[0], a[0], b[0], tc, device=CPU)
        with pytest.raises(ValueError, match="M, N"):
            tops.solve_uv(K, a, b, tc, device=CPU)
        with pytest.raises(ValueError, match="a must be"):
            tops.solve_uv(K[0], a[0][:5], b[0], tc, device=CPU)

    def test_wide_rows_raise_on_every_device(self):
        """The kernels' limit (one block's column accumulator) holds on
        the CPU too, so a shape refused on the card is refused here."""
        _, tc = cfgs(num_iters=1)
        N = 60_000
        with pytest.raises(ValueError, match="too wide"):
            tops.solve_uv(np.ones((1, N), np.float32), np.ones(1, np.float32),
                          np.ones(N, np.float32), tc, device=CPU)
        with pytest.raises(ValueError, match="too wide"):
            tops.solve_uv_batched(np.ones((2, 1, N), np.float32),
                                  np.ones((2, 1), np.float32),
                                  np.ones((2, N), np.float32), tc,
                                  device=CPU)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("checks the refusal on a machine without CUDA")
        _, tc = cfgs()
        K, a, b = problem(8, 16, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.solve_uv(K, a, b, tc)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.solve_uv_batched(K[None], a[None], b[None], tc)

    def test_operand_types_and_inputs_not_written(self):
        _, tc = cfgs(num_iters=5)
        K, a, b = problem(16, 24, 4)
        K0, Kt = K.copy(), torch.tensor(K)
        P64, (u64, v64) = tops.solve_uv(K.astype(np.float64), a, b, tc,
                                        device=CPU)
        P, (u, v) = tops.solve_uv(Kt, a, b, tc, device=CPU)
        assert torch.equal(P64, P) and torch.equal(v64, v)
        np.testing.assert_array_equal(K, K0)
        np.testing.assert_array_equal(Kt.numpy(), K0)
        Pb, (ub_, vb) = tops.solve_uv(Kt.to(torch.bfloat16), a, b, tc,
                                      device=CPU)
        assert Pb.dtype == torch.float32
        # the bf16 path reads the rounded K: it equals the fp32 path on it
        Pr, (ur, vr) = tops.solve_uv(Kt.to(torch.bfloat16).float(), a, b,
                                     tc, device=CPU)
        assert torch.equal(Pb, Pr) and torch.equal(vb, vr)


class TestCoreSolvers:
    @pytest.mark.parametrize("ti", [False, True])
    def test_sinkhorn_uot_uv_tol_matches_reference(self, ti):
        jc, tc = cfgs(reg=0.05, num_iters=2000, tol=1e-5,
                      translation_invariant=ti)
        K, a, b = problem(60, 48, 7, reg=0.05, mass=1.6)
        assert thealth.uv_safe(tc, a, b)
        Pj, (uj, vj), sj = juv.sinkhorn_uot_uv(
            jnp.asarray(K), jnp.asarray(a), jnp.asarray(b), jc)
        P, (u, v), st = tuv.sinkhorn_uot_uv(
            torch.tensor(K), torch.tensor(a), torch.tensor(b), tc)
        assert st["iters"] == int(sj["iters"]) < 2000
        assert st["err"] <= 1e-5 and float(sj["err"]) <= 1e-5
        np.testing.assert_allclose(f32(u), f32(uj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(v), f32(vj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(P), f32(Pj), **P_SOLVE)

    def test_translation_cuts_iterations_as_in_reference(self):
        kw = dict(reg=0.05, num_iters=5000, tol=1e-6)
        K, a, b = problem(40, 64, 8, reg=0.05, mass=1.6)
        args = [torch.tensor(x) for x in (K, a, b)]
        _, _, s_plain = tuv.sinkhorn_uot_uv(*args, cfgs(**kw)[1])
        _, _, s_ti = tuv.sinkhorn_uot_uv(
            *args, cfgs(translation_invariant=True, **kw)[1])
        assert s_ti["iters"] < s_plain["iters"]

    @pytest.mark.parametrize("ti", [False, True])
    def test_sinkhorn_uot_uv_fused_matches_reference(self, ti):
        jc, tc = cfgs(reg=0.05, num_iters=40, translation_invariant=ti)
        K, a, b = problem(50, 70, 9, reg=0.05, mass=1.4)
        Pj, (uj, vj), sj = juv.sinkhorn_uot_uv_fused(
            jnp.asarray(K), jnp.asarray(a), jnp.asarray(b), jc)
        P, (u, v), st = tuv.sinkhorn_uot_uv_fused(
            torch.tensor(K), torch.tensor(a), torch.tensor(b), tc)
        assert st["iters"] == int(sj["iters"]) == 40
        np.testing.assert_allclose(f32(u), f32(uj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(v), f32(vj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(P), f32(Pj), **P_SOLVE)
        # the two core solvers share their iterates
        P2, (u2, _), _ = tuv.sinkhorn_uot_uv(
            torch.tensor(K), torch.tensor(a), torch.tensor(b), tc)
        assert torch.equal(u2, u) and torch.equal(P2, P)

    def test_iteration_and_translation_match_reference(self):
        K, a, b = problem(30, 40, 10)
        v = np.random.default_rng(1).uniform(0.5, 2.0, 40).astype(np.float32)
        uj, vj = juv.uv_fused_iteration(jnp.asarray(K), jnp.asarray(v),
                                        jnp.asarray(a), jnp.asarray(b), 0.9)
        u, vn = tuv.uv_fused_iteration(torch.tensor(K), torch.tensor(v),
                                       torch.tensor(a), torch.tensor(b), 0.9)
        np.testing.assert_allclose(f32(u), f32(uj), **CALL)
        np.testing.assert_allclose(f32(vn), f32(vj), **CALL)
        uz = np.array(uj).copy()
        uz[3] = 0.0                          # zero entries stay zero
        ut, vt = juv.translate_uv(jnp.asarray(uz), vj, jnp.asarray(a),
                                  jnp.asarray(b), 0.05, 1.0)
        up, vp = tuv.translate_uv(torch.tensor(uz), vn, torch.tensor(a),
                                  torch.tensor(b), 0.05, 1.0)
        assert float(up[3]) == 0.0
        np.testing.assert_allclose(f32(up), f32(ut), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(vp), f32(vt), rtol=UV_RTOL)
        for amp in (10.0, 0.5):
            assert tuv.translation_noise_floor(amp, torch.float32) == \
                juv.translation_noise_floor(amp, jnp.float32)

    def test_log_domain_uses_the_shared_noise_floor(self):
        assert tlog.translation_noise_floor is tuv.translation_noise_floor

    def test_balanced_translation_is_a_noop(self):
        K, a, b = problem(24, 36, 11, mass=1.0)
        args = [torch.tensor(x) for x in (K, a, b)]
        kw = dict(reg=0.05, reg_m=float("inf"), num_iters=30)
        P, _, _ = tuv.sinkhorn_uot_uv(*args, cfgs(**kw)[1])
        P_ti, _, _ = tuv.sinkhorn_uot_uv(
            *args, cfgs(translation_invariant=True, **kw)[1])
        assert torch.equal(P, P_ti)


class TestGeometryPath:
    def test_grid_geometry_matches_reference_and_dense(self):
        rng = np.random.default_rng(9)
        factors = (rng.uniform(0, 1, (8, 10)).astype(np.float32),
                   rng.uniform(0, 1, (6, 5)).astype(np.float32))
        jg = JGrid(tuple(jnp.asarray(C) for C in factors))
        g = convert.geometry_from_numpy(fields(jg), CPU)
        M, N = g.shape
        a = (rng.uniform(0.5, 1.5, M) / M).astype(np.float32)
        b = (rng.uniform(0.5, 1.5, N) / N).astype(np.float32)
        jc, tc = cfgs(num_iters=60, tol=1e-7)
        Pj, (uj, vj), sj = juv.sinkhorn_uot_uv(jg, jnp.asarray(a),
                                               jnp.asarray(b), jc)
        P, (u, v), st = tuv.sinkhorn_uot_uv(g, torch.tensor(a),
                                            torch.tensor(b), tc)
        assert st["iters"] == int(sj["iters"])
        np.testing.assert_allclose(f32(v), f32(vj), rtol=UV_RTOL)
        np.testing.assert_allclose(f32(P), f32(Pj), **P_SOLVE)
        Pd, _, sd = tuv.sinkhorn_uot_uv(g.kernel(tc.reg), torch.tensor(a),
                                        torch.tensor(b), tc)
        assert sd["iters"] == st["iters"]
        np.testing.assert_allclose(f32(P), f32(Pd), **P_SOLVE)

    def test_point_cloud_geometry_matches_reference(self):
        rng = np.random.default_rng(7)
        x = rng.uniform(0, 1, (150, 2)).astype(np.float32)
        y = rng.uniform(0, 1, (80, 2)).astype(np.float32)
        a = (rng.uniform(0.5, 1.5, 150) / 150).astype(np.float32)
        b = (rng.uniform(0.5, 1.5, 80) / 80 * 1.2).astype(np.float32)
        jg = JPC.from_points(jnp.asarray(x), jnp.asarray(y))
        g = convert.geometry_from_numpy(fields(jg), CPU)
        for solver in ("sinkhorn_uot_uv", "sinkhorn_uot_uv_fused"):
            jc, tc = cfgs(reg=0.5, num_iters=40)
            Pj, (uj, vj), _ = getattr(juv, solver)(jg, jnp.asarray(a),
                                                  jnp.asarray(b), jc)
            P, (u, v), _ = getattr(tuv, solver)(g, torch.tensor(a),
                                                torch.tensor(b), tc)
            assert P.shape == (150, 80)
            np.testing.assert_allclose(f32(u), f32(uj), rtol=UV_RTOL)
            np.testing.assert_allclose(f32(v), f32(vj), rtol=UV_RTOL)
            np.testing.assert_allclose(f32(P), f32(Pj), **P_SOLVE)
