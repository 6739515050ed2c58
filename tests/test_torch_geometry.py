"""PyTorch port, cost geometries: ``repro_torch.geometry``, kernels h, i, j,
k (plain versions), the ``geometry=`` solve paths and the point-cloud
serving paths.

The same numpy inputs, made from a seed, go through the JAX reference —
its Pallas kernels in interpret mode (``interpret=True`` /
``impl='kernel', interpret=True``), as the reference's own tests run them
on the CPU — and through the port, whose wrappers take their plain
PyTorch versions for CPU tensors. A reference geometry is carried across
with ``repro_torch.convert.geometry_from_numpy`` (its squared norms
included), so both packages evaluate the same coordinates and norms.

Tolerances, and why:
  * tile arithmetic per entry, rtol 1e-6: ``gibbs_tile`` / ``kernel()`` at
    reg 1 and 2. XLA contracts the reference's multiply-add chains
    into FMAs, so its cost differs from the port's by an ulp or two of the
    norms, and ``exp(-C / reg)`` carries that absolute error times 1 /
    reg (at the solves' reg 0.05 the kernels differ by up to ~5e-6 per
    entry, which the solve tolerance covers);
  * ``cost()`` per entry, 1e-6 of the problem's largest cost: near the
    diagonal C is a difference of nearly equal norms, where a bound
    relative to each value means nothing;
  * ``valid_mask`` and every masked region: exact;
  * lazy applications: rtol 1e-5, atol 1e-7 (matrix products and
    logsumexps sum in other orders);
  * one kernel call (h, i, j plain versions against the reference's
    kernels): fp32 rtol 1e-5, atol 1e-7 at reg 0.5; bf16 one bf16
    rounding per entry (the two sides round nearly equal fp32 values);
  * whole solves: fp32 relative 1e-4 of the largest entry, bf16 the
    reference's bars (5e-2 pointwise, 1e-2 mass), iteration counts equal
    wherever the API reports them (the resident tier, the scheduler).
Inside the port (plain versions on the CPU) the geometry path and the
dense path over ``geometry.kernel()`` are held bit for bit, iteration
counts equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import UOTConfig as JConfig
from repro.geometry import DenseGeometry as JDense
from repro.geometry import GridGeometry as JGrid
from repro.geometry import PointCloudGeometry as JPC
from repro.kernels import ops as jops
from repro.kernels import uot_geometry as jug
from repro.kernels import uot_resident as jur
from repro.serve import UOTBatchEngine as JEngine
from repro.serve import UOTScheduler as JScheduler
from repro_torch import convert
from repro_torch.core import UOTConfig as TConfig
from repro_torch.core import UOTProblem
from repro_torch.geometry import (DenseGeometry, Geometry, GridGeometry,
                                  PointCloudGeometry)
from repro_torch.geometry import pointcloud as tpc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import uot_geometry as tug
from repro_torch.kernels import uot_resident as tur
from repro_torch.serve import UOTBatchEngine, UOTScheduler

TILE_RTOL = 1e-6
CALL = dict(rtol=1e-5, atol=1e-7)
LAZY = dict(rtol=1e-5, atol=1e-7)
RTOL_SOLVE = 1e-4
BF16_ULP = 2.0 ** -7
BF16_POINT, BF16_MASS = 5e-2, 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = "cpu"


def clouds(B, M, N, d, seed, ragged=True):
    """(x, y, m_valid, n_valid, a, b): coordinates in the unit cube, valid
    counts (the first problem full), marginals zero past the counts."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, M, d)).astype(np.float32)
    y = rng.uniform(0, 1, (B, N, d)).astype(np.float32)
    mv = np.full(B, M, np.int32)
    nv = np.full(B, N, np.int32)
    if ragged:
        mv[1:] = rng.integers(M // 2, M, B - 1)
        nv[1:] = rng.integers(N // 2, N, B - 1)
    a = np.zeros((B, M), np.float32)
    b = np.zeros((B, N), np.float32)
    for k in range(B):
        a[k, :mv[k]] = rng.uniform(0.5, 1.5, mv[k]) / mv[k]
        b[k, :nv[k]] = rng.uniform(0.5, 1.5, nv[k]) / nv[k] * 1.2
    return x, y, mv, nv, a, b


def fields(g):
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


def port(jg):
    """The port's copy of a reference geometry, on the CPU."""
    return convert.geometry_from_numpy(fields(jg), CPU)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def rel(x, ref):
    x, ref = np.asarray(f32(x), np.float64), np.asarray(f32(ref), np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


def per_entry(got, want, rtol):
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    assert got.shape == want.shape
    bad = np.abs(got - want) > rtol * np.abs(want)
    assert not bad.any(), (int(bad.sum()), float(
        (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()))


def close_call(got, want, dname):
    if dname == "bfloat16":
        per_entry(got, want, BF16_ULP)
    else:
        np.testing.assert_allclose(f32(got), f32(want), **CALL)


def close_solve(got, want, dname):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    if dname == "bfloat16":
        assert np.abs(got - want).max() <= BF16_POINT * np.abs(want).max()
        assert abs(got.sum() - want.sum()) <= BF16_MASS * abs(want.sum())
    else:
        assert rel(got, want) <= RTOL_SOLVE, rel(got, want)


def cfgs(dname="float32", **kw):
    base = dict(reg=0.05, reg_m=1.0, num_iters=30)
    base.update(kw)
    jdt, tdt = DTYPES[dname]
    return JConfig(dtype=jdt, **base), TConfig(dtype=tdt, **base)


def masked_zero(P, mv, nv):
    """Every entry of a (B, M, N) result past its valid counts is 0.0."""
    P = f32(P)
    for k in range(P.shape[0]):
        assert (P[k, mv[k]:, :] == 0.0).all()
        assert (P[k, :, nv[k]:] == 0.0).all()


def jax_operands(jg, M, N, bm=8):
    """The reference's kernel operands, padded to its own alignment."""
    Mp, Np = M + (-M) % bm, N + (-N) % 128
    return jops._pc_padded_operands(jg, Mp, Np)


def port_operands(g):
    return g.operands(CPU)


# ---- the geometry objects -----------------------------------------------------

class TestTileArithmetic:
    @pytest.mark.parametrize("d", [2, 3])
    @pytest.mark.parametrize("scale", [1.0, 2.5])
    def test_gibbs_tile_kernel_cost_and_mask(self, d, scale):
        x, y, mv, nv, _, _ = clouds(3, 48, 110, d, seed=d)
        jg = JPC.from_points(x, y, scale=scale, m_valid=mv, n_valid=nv)
        g = port(jg)
        for reg in (1.0, 2.0):
            K, Kj = g.kernel(reg), np.asarray(jg.kernel(reg))
            assert K.dtype == torch.float32 and K.shape == (3, 48, 110)
            per_entry(K, Kj, TILE_RTOL)
            masked_zero(K, mv, nv)
            tile = tpc.gibbs_tile(g.x, g.xn[..., None], g.y,
                                  g.yn[..., None, :], reg=reg, scale=scale)
            jtile = jug.gibbs_tile(jnp.asarray(x), jg.xn[..., None],
                                   jnp.asarray(y), jg.yn[..., None, :],
                                   reg=reg, scale=scale)
            per_entry(tile, np.asarray(jtile), TILE_RTOL)
        mask = tpc.valid_mask(48, 110, torch.tensor(mv), torch.tensor(nv))
        from repro.geometry.pointcloud import valid_mask as jmask
        np.testing.assert_array_equal(mask.numpy(),
                                      np.asarray(jmask(48, 110, mv, nv)))
        gu = port(JPC.from_points(x[0], y[0], scale=scale))
        C, Cj = gu.cost(), np.asarray(JPC.from_points(
            x[0], y[0], scale=scale).cost())
        assert np.abs(f32(C) - Cj).max() <= TILE_RTOL * np.abs(Cj).max()

    def test_norms_and_from_points(self):
        x, y, *_ = clouds(1, 40, 100, 3, seed=4, ragged=False)
        g = PointCloudGeometry.from_points(x[0], y[0], scale=2.0, device=CPU)
        jg = JPC.from_points(x[0], y[0], scale=2.0)
        np.testing.assert_allclose(g.xn.numpy(), np.asarray(jg.xn),
                                   rtol=TILE_RTOL)
        np.testing.assert_allclose(g.yn.numpy(), np.asarray(jg.yn),
                                   rtol=TILE_RTOL)
        assert g.shape == jg.shape == (40, 100) and g.is_implicit
        assert g.dim == 3 and g.batch_shape == ()
        assert g.payload_nbytes() == jg.payload_nbytes() == 4 * 140 * 4

    def test_masked_geometry_refuses_cost_and_lazy_paths(self):
        x, y, *_ = clouds(1, 32, 48, 2, seed=5, ragged=False)
        g = PointCloudGeometry.from_points(x[0], y[0], m_valid=20,
                                           n_valid=30, device=CPU)
        v, u = torch.ones(48), torch.ones(32)
        for call in (g.cost, lambda: g.apply_kernel(v, 0.1),
                     lambda: g.apply_kernel_T(u, 0.1),
                     lambda: g.apply_lse(v, 0.1),
                     lambda: g.apply_lse_T(u, 0.1)):
            with pytest.raises(ValueError, match="slice the"):
                call()
        K = g.kernel(0.1)
        assert (K[20:] == 0).all() and (K[:, 30:] == 0).all()
        assert (K[:20, :30] > 0).all()

    def test_dim_mismatch_raises(self):
        with pytest.raises(ValueError, match="coordinate dims"):
            PointCloudGeometry.from_points(np.zeros((4, 3)), np.zeros((5, 2)),
                                           device=CPU)

    @pytest.mark.parametrize("kind", ["pc", "grid", "dense"])
    def test_lazy_applications_match_reference(self, kind):
        rng = np.random.default_rng(6)
        if kind == "pc":
            x, y, *_ = clouds(1, 300, 120, 3, seed=6, ragged=False)
            jg = JPC.from_points(x[0], y[0], scale=1.5)
        elif kind == "grid":
            jg = JGrid(tuple(jnp.asarray(rng.uniform(0, 1, s).astype(
                np.float32)) for s in ((8, 10), (5, 6))))
        else:
            jg = JDense(jnp.asarray(rng.uniform(0, 1, (40, 60)).astype(
                np.float32)))
        g = port(jg)
        M, N = g.shape
        reg = 0.5
        v = rng.uniform(size=N).astype(np.float32)
        u = rng.uniform(size=M).astype(np.float32)
        zs, zu = (v - 0.5) / 2, (u - 0.5) / 2
        for got, want in (
                (g.apply_kernel(torch.tensor(v), reg),
                 jg.apply_kernel(jnp.asarray(v), reg)),
                (g.apply_kernel_T(torch.tensor(u), reg),
                 jg.apply_kernel_T(jnp.asarray(u), reg)),
                (g.apply_lse(torch.tensor(zs), reg),
                 jg.apply_lse(jnp.asarray(zs), reg)),
                (g.apply_lse_T(torch.tensor(zu), reg),
                 jg.apply_lse_T(jnp.asarray(zu), reg)),
                (g.kernel(reg), jg.kernel(reg))):
            np.testing.assert_allclose(f32(got), np.asarray(want), **LAZY)
        if kind != "pc":
            np.testing.assert_allclose(f32(g.cost()), np.asarray(jg.cost()),
                                       **LAZY)

    def test_uot_problem_carries_geometry(self):
        x, y, _, _, a, b = clouds(1, 20, 30, 2, seed=7, ragged=False)
        p = UOTProblem.from_points(x[0], y[0], a[0], b[0], scale=3.0,
                                   device=CPU)
        assert p.shape == (20, 30) and isinstance(p.geom(), PointCloudGeometry)
        assert torch.equal(p.initial_coupling(0.1), p.geometry.kernel(0.1))
        assert p.initial_coupling(0.1, torch.bfloat16).dtype == torch.bfloat16
        pd = UOTProblem.from_cost(p.cost_matrix(), a[0], b[0])
        assert isinstance(pd.geom(), DenseGeometry)
        np.testing.assert_allclose(f32(pd.initial_coupling(0.5)),
                                   f32(p.initial_coupling(0.5)), **LAZY)
        grid = UOTProblem.from_grid([np.ones((4, 5), np.float32),
                                     np.zeros((2, 3), np.float32)],
                                    np.ones(8), np.ones(15), device=CPU)
        assert grid.shape == (8, 15) and isinstance(grid.geom(), GridGeometry)
        with pytest.raises(ValueError, match="exactly one"):
            UOTProblem(a=torch.ones(2), b=torch.ones(3))
        with pytest.raises(ValueError, match="exactly one"):
            UOTProblem(a=torch.ones(2), b=torch.ones(3),
                       C=torch.ones(2, 3), geometry=p.geometry)


class TestConvert:
    def test_each_geometry_carries_across_and_back(self):
        x, y, mv, nv, *_ = clouds(2, 24, 40, 3, seed=8)
        rng = np.random.default_rng(8)
        refs = [JPC.from_points(x, y, scale=2.0, m_valid=mv, n_valid=nv),
                JGrid((jnp.asarray(rng.uniform(size=(3, 4)), jnp.float32),
                       jnp.asarray(rng.uniform(size=(5, 2)), jnp.float32))),
                JDense(jnp.asarray(rng.uniform(size=(6, 7)), jnp.float32))]
        for jg, cls in zip(refs, (PointCloudGeometry, GridGeometry,
                                  DenseGeometry)):
            g = port(jg)
            assert isinstance(g, cls) and g.shape == jg.shape
            back = convert.geometry_to_numpy(g)
            for name, value in fields(jg).items():
                if isinstance(value, tuple):
                    for p, q in zip(back[name], value):
                        np.testing.assert_array_equal(p, np.asarray(q))
                elif isinstance(value, float):
                    assert back[name] == value
                else:
                    np.testing.assert_array_equal(back[name],
                                                  np.asarray(value))
        with pytest.raises(ValueError, match="geometry"):
            convert.geometry_from_numpy({"z": 1}, CPU)


# ---- kernels h, i, j, k: the plain versions against the reference ----------

class TestKernelsAgainstReference:
    CASES = [(3, 48, 110, 2), (2, 64, 130, 3)]

    @pytest.mark.parametrize("B,M,N,d", CASES)
    @pytest.mark.parametrize("dname", list(DTYPES))
    def test_h_i_j(self, B, M, N, d, dname):
        jdt, tdt = DTYPES[dname]
        x, y, mv, nv, a, b = clouds(B, M, N, d, seed=M + d)
        jg = JPC.from_points(x, y, scale=1.5, m_valid=mv, n_valid=nv)
        g = port(jg)
        jo, to = jax_operands(jg, M, N), port_operands(g)
        kw = dict(reg=0.5, scale=1.5)
        K = tug.batched_pc_materialize(*to, out_dtype=tdt, **kw)
        Kj = jug.batched_pc_materialize(*jo, block_m=8, interpret=True,
                                        out_dtype=jdt, **kw)
        assert K.dtype == tdt
        close_call(K, np.asarray(Kj)[:, :M, :N], dname)
        masked_zero(K, mv, nv)
        cs = tug.batched_pc_colsum(*to, storage_dtype=tdt, **kw)
        csj = jug.batched_pc_colsum(*jo, block_m=8, interpret=True,
                                    storage_dtype=jdt, **kw)
        np.testing.assert_allclose(cs.numpy(), np.asarray(csj)[:, :N],
                                   rtol=1e-5 if dname == "float32"
                                   else BF16_ULP, atol=1e-7)
        fcol = torch.rand(B, N, generator=torch.Generator().manual_seed(1))
        fcol = fcol + 0.5
        fi = 1.0 / 1.05
        A1, c1, f1 = tug.batched_pc_first_iteration(
            fcol, torch.tensor(a), *to, fi=fi, out_dtype=tdt, **kw)
        ap = np.pad(a, ((0, 0), (0, jo[0].shape[1] - M)))
        A1j, c1j, f1j = jug.batched_pc_first_iteration(
            jnp.pad(jnp.asarray(fcol.numpy()),
                    ((0, 0), (0, jo[2].shape[1] - N))),
            jnp.asarray(ap), *jo, fi=fi, block_m=8, interpret=True,
            out_dtype=jdt, **kw)
        close_call(A1, np.asarray(A1j)[:, :M, :N], dname)
        masked_zero(A1, mv, nv)
        if dname == "float32":
            np.testing.assert_allclose(c1.numpy(), np.asarray(c1j)[:, :N],
                                       **CALL)
            np.testing.assert_allclose(f1.numpy(), np.asarray(f1j)[:, :M],
                                       **CALL)
        else:
            close_solve(c1, np.asarray(c1j)[:, :N], dname)
            close_solve(f1, np.asarray(f1j)[:, :M], dname)

    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("tol", [None, 1e-4])
    def test_k(self, dname, tol):
        jdt, tdt = DTYPES[dname]
        B, M, N, d = 3, 40, 100, 2
        x, y, mv, nv, a, b = clouds(B, M, N, d, seed=11)
        jg = JPC.from_points(x, y, m_valid=mv, n_valid=nv)
        g = port(jg)
        jo = jax_operands(jg, M, N)
        Mp, Np = jo[0].shape[1], jo[2].shape[1]
        kw = dict(fi=1.0 / 1.05, reg=0.05, num_iters=60, tol=tol)
        to = port_operands(g)
        P, cs, it, err = tur.resident_solve_pc(
            *to[:4], torch.tensor(a), torch.tensor(b), *to[4:],
            out_dtype=tdt, **kw)
        Pj, csj, itj, errj = jur.resident_solve_pc(
            *jo[:4], jnp.pad(jnp.asarray(a), ((0, 0), (0, Mp - M))),
            jnp.pad(jnp.asarray(b), ((0, 0), (0, Np - N))), *jo[4:],
            interpret=True, out_dtype=jdt, **kw)
        close_solve(P, np.asarray(Pj)[:, :M, :N], dname)
        close_solve(cs, np.asarray(csj)[:, :N], "float32")
        np.testing.assert_array_equal(it.numpy(), np.asarray(itj))
        masked_zero(P, mv, nv)
        if tol is not None:
            assert int(it.max()) < 60 and float(err.max()) <= tol


# ---- the geometry= solve paths against the reference --------------------------

class TestSolvesAgainstReference:
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("tol", [None, 1e-4])
    @pytest.mark.parametrize("impl", [None, "auto"])
    def test_solve_fused(self, dname, tol, impl):
        jc, tc = cfgs(dname, num_iters=40, tol=tol)
        x, y, _, _, a, b = clouds(1, 56, 120, 3, seed=12, ragged=False)
        jg = JPC.from_points(x[0], y[0], scale=2.0)
        P, cs = tops.solve_fused(None, a[0], b[0], tc, geometry=port(jg),
                                 impl=impl, device=CPU)
        Pj, csj = jops.solve_fused(None, jnp.asarray(a[0]),
                                   jnp.asarray(b[0]), jc, geometry=jg,
                                   impl=impl or "kernel", interpret=True)
        assert P.dtype == DTYPES[dname][1] and P.shape == (56, 120)
        close_solve(P, Pj, dname)
        close_solve(cs, csj, "float32" if dname == "float32" else dname)

    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("tol", [None, 1e-4])
    def test_solve_fused_batched_ragged(self, dname, tol):
        jc, tc = cfgs(dname, num_iters=40, tol=tol)
        x, y, mv, nv, a, b = clouds(4, 48, 100, 2, seed=13)
        jg = JPC.from_points(x, y, m_valid=mv, n_valid=nv)
        P, cs = tops.solve_fused_batched(None, a, b, tc, geometry=port(jg),
                                         device=CPU)
        Pj, csj = jops.solve_fused_batched(
            None, jnp.asarray(a), jnp.asarray(b), jc, geometry=jg,
            impl="kernel", interpret=True)
        for k in range(4):
            close_solve(P[k], Pj[k], dname)
        close_solve(cs, csj, "float32" if dname == "float32" else dname)
        masked_zero(P, mv, nv)

    @pytest.mark.parametrize("tol", [None, 1e-4])
    def test_solve_fused_resident(self, tol):
        jc, tc = cfgs(num_iters=200, tol=tol)
        x, y, _, _, a, b = clouds(1, 40, 100, 3, seed=14, ragged=False)
        jg = JPC.from_points(x[0], y[0])
        P, cs, it, err = tops.solve_fused_resident(
            None, a[0], b[0], tc, geometry=port(jg), device=CPU)
        Pj, csj, itj, errj = jops.solve_fused_resident(
            None, jnp.asarray(a[0]), jnp.asarray(b[0]), jc, geometry=jg,
            impl="kernel", interpret=True)
        close_solve(P, Pj, "float32")
        close_solve(cs, csj, "float32")
        assert int(it) == int(itj)
        if tol is not None:
            assert int(it) < 200 and float(err) <= tol

    def test_dense_and_grid_geometries_take_the_dense_path(self):
        jc, tc = cfgs(num_iters=25, tol=1e-4)
        rng = np.random.default_rng(15)
        jgrid = JGrid((jnp.asarray(rng.uniform(0, 1, (6, 8)), jnp.float32),
                       jnp.asarray(rng.uniform(0, 1, (7, 12)), jnp.float32)))
        a = (rng.uniform(0.5, 1.5, 42) / 42).astype(np.float32)
        b = (rng.uniform(0.5, 1.5, 96) / 96).astype(np.float32)
        for jg in (jgrid, JDense(jgrid.cost())):
            g = port(jg)
            P, _ = tops.solve_fused(None, a, b, tc, geometry=g, device=CPU)
            Pj, _ = jops.solve_fused(None, jnp.asarray(a), jnp.asarray(b),
                                     jc, geometry=jg, impl="kernel",
                                     interpret=True)
            close_solve(P, Pj, "float32")
            P2, _, it, _ = tops.solve_fused_resident(None, a, b, tc,
                                                     geometry=g, device=CPU)
            Pd, _, itd, _ = tops.solve_fused_resident(
                g.kernel(tc.reg), a, b, tc, device=CPU)
            assert torch.equal(P2, Pd) and int(it) == int(itd)


# ---- in the port: the geometry path equals the dense path, bit for bit -----

class TestGeometryEqualsDense:
    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("tol", [None, 1e-5])
    @pytest.mark.parametrize("impl", [None, "auto", "resident"])
    def test_batched_ragged_bitwise(self, dname, tol, impl):
        _, tc = cfgs(dname, num_iters=30, tol=tol)
        x, y, mv, nv, a, b = clouds(3, 48, 100, 3, seed=16)
        g = PointCloudGeometry.from_points(x, y, scale=2.0, m_valid=mv,
                                           n_valid=nv, device=CPU)
        K = g.kernel(tc.reg)
        Pd, csd = tops.solve_fused_batched(K, a, b, tc, impl=impl,
                                           device=CPU)
        Pg, csg = tops.solve_fused_batched(None, a, b, tc, impl=impl,
                                           geometry=g, device=CPU)
        assert torch.equal(Pg, Pd) and torch.equal(csg, csd)
        masked_zero(Pg, mv, nv)

    @pytest.mark.parametrize("dname", list(DTYPES))
    def test_resident_iteration_counts_bitwise(self, dname):
        _, tc = cfgs(dname, num_iters=200, tol=1e-4)
        x, y, _, _, a, b = clouds(2, 40, 100, 2, seed=17, ragged=False)
        g = PointCloudGeometry.from_points(x, y, device=CPU)
        Pd, _, itd, errd = tops.solve_fused_resident(g.kernel(tc.reg), a, b,
                                                     tc, device=CPU)
        Pg, _, itg, errg = tops.solve_fused_resident(None, a, b, tc,
                                                     geometry=g, device=CPU)
        assert torch.equal(Pg, Pd) and torch.equal(itg, itd)
        assert torch.equal(errg, errd) and int(itg.max()) < 200

    def test_kernels_h_i_k_equal_dense_kernels_on_j(self):
        x, y, mv, nv, a, b = clouds(3, 40, 100, 3, seed=18)
        g = PointCloudGeometry.from_points(x, y, m_valid=mv, n_valid=nv,
                                           device=CPU)
        ops_ = port_operands(g)
        kw = dict(reg=0.05, scale=1.0)
        for tdt in (torch.float32, torch.bfloat16):
            K = tug.batched_pc_materialize(*ops_, out_dtype=tdt, **kw)
            from repro_torch.kernels import uot_batched as tub
            assert torch.equal(
                tug.batched_pc_colsum(*ops_, storage_dtype=tdt, **kw),
                tub.batched_colsum(K))
            fcol = torch.rand(3, 100) + 0.5
            A1, c1, f1 = tug.batched_pc_first_iteration(
                fcol, torch.tensor(a), *ops_, fi=0.9, out_dtype=tdt, **kw)
            live = torch.ones(3, dtype=torch.bool)
            Kd, cd, fd = tub.batched_fused_iteration_frow(
                K.clone(), fcol, torch.tensor(a), live, torch.zeros(3, 100),
                fi=0.9)
            assert torch.equal(A1, Kd) and torch.equal(c1, cd)
            assert torch.equal(f1, fd)
            P, cs, it, err = tur.resident_solve_pc(
                *ops_[:4], torch.tensor(a), torch.tensor(b), *ops_[4:],
                fi=0.9, num_iters=20, tol=1e-6, out_dtype=tdt, **kw)
            Pf, csf, itf, errf = tur.resident_solve(
                K.clone(), torch.tensor(a), torch.tensor(b), fi=0.9,
                num_iters=20, tol=1e-6)
            assert torch.equal(P, Pf) and torch.equal(cs, csf)
            assert torch.equal(it, itf) and torch.equal(err, errf)

    def test_num_iters_zero_materializes_the_kernel(self):
        _, tc = cfgs(num_iters=0)
        x, y, mv, nv, a, b = clouds(2, 24, 40, 2, seed=19)
        g = PointCloudGeometry.from_points(x, y, m_valid=mv, n_valid=nv,
                                           device=CPU)
        tug.reset_counts()
        P, cs = tops.solve_fused_batched(None, a, b, tc, geometry=g,
                                         device=CPU)
        assert tug.PLAIN_CALLS == {"batched_pc_colsum": 1,
                                   "batched_pc_first_iteration": 0,
                                   "batched_pc_materialize": 1}
        K = g.kernel(tc.reg)
        assert torch.equal(P, K) and torch.equal(cs, K.sum(dim=1))


# ---- serving ------------------------------------------------------------------

SERVE_SHAPES = [(50, 110), (50, 110), (30, 100), (60, 120), (44, 105)]


def point_requests(d=3):
    out = []
    for s, (M, N) in enumerate(SERVE_SHAPES):
        x, y, _, _, a, b = clouds(1, M, N, d, seed=30 + s, ragged=False)
        out.append((x[0], y[0], a[0], b[0]))
    return out


class TestServing:
    CFG = dict(reg=0.05, reg_m=1.0, num_iters=40, tol=1e-5)

    @pytest.mark.parametrize("impl", [None, "auto"])
    def test_engine_points_match_reference(self, impl):
        jc, tc = cfgs(**self.CFG)
        je = JEngine(jc, interpret=True, impl=impl or "kernel")
        te = UOTBatchEngine(tc, impl=impl, device=CPU)
        rids = [(je.submit_points(x, y, a, b, scale=2.0),
                 te.submit_points(x, y, a, b, scale=2.0))
                for x, y, a, b in point_requests()]
        rj, rt = je.flush(), te.flush()
        assert not te.pending and len(rt) == len(rids)
        for rid_j, rid_t in rids:
            close_solve(rt[rid_t], np.asarray(rj[rid_j]), "float32")
        if impl == "auto":
            assert set(te.last_dispatch.values()) == {"resident"}

    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("impl", [None, "auto"])
    def test_engine_points_equal_dense_submission(self, dname, impl):
        _, tc = cfgs(dname, **self.CFG)
        ep = UOTBatchEngine(tc, impl=impl, device=CPU)
        ed = UOTBatchEngine(tc, impl=impl, device=CPU)
        rids = []
        for x, y, a, b in point_requests():
            g = PointCloudGeometry.from_points(x, y, scale=2.0, device=CPU)
            rids.append((ep.submit_points(x, y, a, b, scale=2.0),
                         ed.submit(g.kernel(tc.reg).numpy(), a, b)))
        rp, rd = ep.flush(), ed.flush()
        for rid_p, rid_d in rids:
            np.testing.assert_array_equal(rp[rid_p], rd[rid_d])

    def test_scheduler_points_match_reference(self):
        jc, tc = cfgs(**self.CFG)
        js = JScheduler(jc, interpret=True, impl="kernel", lanes_per_pool=3)
        ts = UOTScheduler(tc, lanes_per_pool=3, device=CPU)
        rids = [(js.submit_points(x, y, a, b), ts.submit_points(x, y, a, b))
                for x, y, a, b in point_requests(d=2)]
        oj, ot = js.run(), ts.run()
        itj = {t.rid: t.iters for t in js.request_log}
        itt = {t.rid: t.iters for t in ts.request_log}
        for rid_j, rid_t in rids:
            close_solve(ot[rid_t], np.asarray(oj[rid_j]), "float32")
            assert itt[rid_t] == itj[rid_j]
        stj = {t.rid: t.status for t in js.request_log}
        stt = {t.rid: t.status for t in ts.request_log}
        assert [stt[r] for _, r in rids] == [stj[r] for r, _ in rids]

    @pytest.mark.parametrize("dname", list(DTYPES))
    @pytest.mark.parametrize("impl", [None, "auto"])
    def test_scheduler_points_equal_dense_submission(self, dname, impl):
        _, tc = cfgs(dname, **self.CFG)
        sp = UOTScheduler(tc, lanes_per_pool=3, impl=impl, device=CPU)
        sd = UOTScheduler(tc, lanes_per_pool=3, impl=impl, device=CPU)
        rids = []
        for x, y, a, b in point_requests():
            g = PointCloudGeometry.from_points(x, y, device=CPU)
            rids.append((sp.submit_points(x, y, a, b),
                         sd.submit(g.kernel(tc.reg).numpy(), a, b)))
        op_, od = sp.run(), sd.run()
        itp = {t.rid: t.iters for t in sp.request_log}
        itd = {t.rid: t.iters for t in sd.request_log}
        for rid_p, rid_d in rids:
            np.testing.assert_array_equal(op_[rid_p], od[rid_d])
            assert itp[rid_p] == itd[rid_d]

    def test_scheduler_mixes_dense_and_point_requests_in_one_pool(self):
        """Against standalone solves of each problem at its own shape, so
        at the whole-solve tolerance: the pool pads to its bucket, and
        padded sums group differently."""
        _, tc = cfgs(**self.CFG)
        s = UOTScheduler(tc, lanes_per_pool=4, device=CPU)
        refs = []
        for i, (x, y, a, b) in enumerate(point_requests()):
            g = PointCloudGeometry.from_points(x, y, device=CPU)
            K = g.kernel(tc.reg)
            rid = (s.submit(K.numpy(), a, b) if i % 2
                   else s.submit_points(x, y, a, b))
            Pk, _ = tops.solve_fused_batched(K[None], a[None], b[None], tc,
                                             device=CPU)
            refs.append((rid, Pk[0]))
        out = s.run()
        assert len(s._pools) == 1
        for rid, Pk in refs:
            close_solve(out[rid], Pk, "float32")

    def test_quarantined_point_request_retries_on_its_kernel(self):
        _, tc = cfgs(**self.CFG)
        s = UOTScheduler(tc, lanes_per_pool=2, device=CPU)
        x, y, a, b = point_requests()[0]
        rid = s.submit_points(x, y, a, b)
        np.testing.assert_array_equal(
            f32(s._request_kernel(s._queue[0])),
            f32(PointCloudGeometry.from_points(x, y, device=CPU).kernel(
                tc.reg)))
        s.step()
        assert s.inject_lane_fault(rid)
        out = s.run()
        assert np.isfinite(out[rid]).all()
        assert s.stats()["retried_ok"] == 1


# ---- the reference's errors ---------------------------------------------------

class TestErrors:
    def test_geometry_errors(self):
        _, tc = cfgs(num_iters=2)
        x, y, mv, nv, a, b = clouds(2, 16, 24, 2, seed=40)
        g = PointCloudGeometry.from_points(x, y, m_valid=mv, n_valid=nv,
                                           device=CPU)
        with pytest.raises(ValueError, match="not both"):
            tops.solve_fused(np.ones((16, 24), np.float32), a[0], b[0], tc,
                             geometry=g, device=CPU)
        with pytest.raises(ValueError, match="not both"):
            tops.solve_fused_batched(np.ones((2, 16, 24), np.float32), a, b,
                                     tc, geometry=g, device=CPU)
        with pytest.raises(ValueError, match="not both"):
            tops.solve_fused_resident(np.ones((2, 16, 24), np.float32), a, b,
                                      tc, geometry=g, device=CPU)
        for call in (tops.solve_fused, tops.solve_fused_batched,
                     tops.solve_fused_resident):
            with pytest.raises(TypeError, match="Geometry"):
                call(None, a, b, tc, geometry=np.ones((16, 24)), device=CPU)
        with pytest.raises(ValueError, match="batch"):
            tops.solve_fused_batched(None, a[:1], b[:1], tc, geometry=g,
                                     device=CPU)
        with pytest.raises(ValueError, match="batch"):
            tops.solve_fused_resident(None, a[:1], b[:1], tc, geometry=g,
                                      device=CPU)
        with pytest.raises(ValueError, match="slice the"):
            g.cost()
        with pytest.raises(ValueError, match="coordinate dims"):
            UOTBatchEngine(tc, device=CPU).submit_points(
                x[0], y[0, :, :1], a[0], b[0])

    def test_resident_over_budget_raises_and_auto_streams(self):
        _, tc = cfgs(num_iters=3)
        x, y, _, _, a, b = clouds(1, 256, 256, 2, seed=41, ragged=False)
        g = PointCloudGeometry.from_points(x, y, device=CPU)
        with pytest.raises(ValueError, match="resident budget"):
            tops.solve_fused_batched(None, a, b, tc, geometry=g,
                                     impl="resident", device=CPU)
        with pytest.raises(ValueError, match="resident budget"):
            tops.solve_fused_resident(None, a, b, tc, geometry=g, device=CPU)
        with tops.dispatch_counters() as c:
            tops.solve_fused_batched(None, a, b, tc, geometry=g, impl="auto",
                                     device=CPU)
        assert c == {"resident": 0, "streamed": 1}


class TestDispatch:
    def test_hopper_implicit_budget_is_the_dense_budget(self):
        """On Hopper kernel k stages nothing besides kernel f's fp32 tile,
        so a point cloud's resident budget is ``resident_fits(M, N)``, the
        dense one (the reference's wider implicit budget is a TPU fact: its
        dense kernel double-buffers an input tile in VMEM). 128x384 and
        100x460 fit, 256x256 and 130x460 do not: the geometry solve and
        the dense solve on its kernel are accepted and refused alike."""
        _, tc = cfgs(num_iters=2)
        for M, N, fits in ((128, 384, True), (256, 256, False),
                           (100, 460, True), (130, 460, False)):
            x, y, _, _, a, b = clouds(1, M, N, 2, seed=M, ragged=False)
            g = PointCloudGeometry.from_points(x[0], y[0], device=CPU)
            for sdt in (torch.float32, torch.bfloat16):
                assert tops.resident_fits(M, N, tc, storage_dtype=sdt) is fits
                for A0, geom in ((None, g), (g.kernel(tc.reg), None)):
                    try:
                        tops.solve_fused_resident(
                            A0, a[0], b[0], tc, storage_dtype=sdt,
                            geometry=geom, device=CPU)
                        accepted = True
                    except ValueError as e:
                        assert "resident budget" in str(e)
                        accepted = False
                    assert accepted is fits, (M, N, sdt, geom is None)

    def test_auto_routes_point_clouds_by_the_budget(self):
        _, tc = cfgs(num_iters=5)
        seen = []

        def obs(kind, **kw):
            seen.append((kind, kw["M"], kw["N"]))

        class Advisor:
            def advise(self, **kw):
                seen.append(("advise", kw["stepped"]))

        for M, N in ((40, 100), (256, 256)):
            x, y, _, _, a, b = clouds(1, M, N, 2, seed=M, ragged=False)
            g = PointCloudGeometry.from_points(x, y, device=CPU)
            with tops.dispatch_observer(obs), \
                    tops.dispatch_advisor(Advisor()):
                tops.solve_fused(None, a[0], b[0], tc, geometry=g,
                                 impl="auto", device=CPU)
        assert seen == [("advise", False), ("resident", 40, 100),
                        ("streamed", 256, 256)]
        assert isinstance(PointCloudGeometry.from_points(
            np.zeros((2, 2)), np.zeros((3, 2)), device=CPU), Geometry)
