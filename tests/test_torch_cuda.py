"""The port's CUDA kernels a, b, f, g, h, i, j, k, l, m, n and o against
their plain versions on the card (all tests carry the ``cuda`` marker and
skip without a card).

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch for CUDA:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances, per entry: |got - want| <= rtol * |want| + 1e-37 + 2**-100 *
(the largest |want| of the problem) — the slack covers only entries that
passed through fp32's subnormal range. rtol is 1e-5 for one fp32 kernel
call and 3e-5 for a whole fp32 resident solve (the kernels and the plain
versions sum in different orders), with iteration counts equal; column
sums and row factors are fp32 in both storage types. bf16 couplings, which
both sides round once from nearly equal fp32 values, are held to one bf16
rounding (2**-7 of the value) per entry, and to 5e-2 pointwise and 1e-2
mass. Final drifts (differences of row factors near 1) within 1e-6
absolute. Repeated launches and closed lanes are held bitwise.

The point-cloud kernels: j's Gibbs entries within 2 ulps of its plain
version (both compute the same separately rounded operations and call the
same ``expf``), one bf16 ulp in bf16; h and i against their plain versions
at the one-call tolerance; k as f. Inside the port, bit for bit: h equals
c over j's output, i equals d over it, and k equals f over it (P, colsum,
iteration counts, drift).

The u/v kernels: l and n (u and K^T u, fp32) at the one-call tolerance;
m and o (two rounded products, then the output rounding) equal their plain
versions bit for bit; ``solve_uv`` / ``solve_uv_batched`` against the plain
u/v iterates at u, v 3e-5 and P 3e-4 per entry.
"""
import numpy as np
import pytest
import torch

from repro_torch.geometry.pointcloud import sq_norms
from repro_torch.kernels import uot_batched as tub
from repro_torch.kernels import uot_fused as tuf
from repro_torch.kernels import uot_geometry as tug
from repro_torch.kernels import uot_resident as tur
from repro_torch.kernels import uot_uv_fused as tuv

F32_CALL = 1e-5       # one kernel call, fp32
F32_SOLVE = 3e-5      # a whole resident solve, fp32
BF16_ULP = 2.0 ** -7  # one bf16 rounding
TINY, FLOOR = 1e-37, 2.0 ** -100
BF16_POINT, BF16_MASS = 5e-2, 1e-2
DRIFT_ATOL = 1e-6     # final drifts: a difference of factors near 1
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_ULPS = {"float32": 2, "bfloat16": 1}   # kernel j against its plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def stack(B, M, N, seed, reg=0.1):
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


def close(got, want, dname, *, call=True):
    """Per entry at the tolerance of ``dname`` and of a kernel ``call``
    or a whole solve (see the module docstring)."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert got.shape == want.shape
    if dname == "bfloat16":
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= BF16_POINT * scale
        assert abs(got.sum() - want.sum()) <= BF16_MASS * abs(want.sum())
    rtol = (BF16_ULP if dname == "bfloat16" else
            F32_CALL if call else F32_SOLVE)
    top = (np.abs(want).max(axis=(-2, -1), keepdims=True) if want.ndim == 3
           else np.abs(want).max())
    bad = np.abs(got - want) > rtol * np.abs(want) + TINY + FLOOR * top
    assert not bad.any(), (int(bad.sum()), want.size)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("M,N", [(4096, 4096), (300, 1500), (9, 16384),
                                 (77, 33)])
def test_kernels_a_b_match_plain_versions(cuda, dname, M, N):
    tdt = DTYPES[dname]
    g = torch.Generator(device=cuda).manual_seed(M + N)
    A = (torch.rand((M, N), generator=g, device=cuda) + 0.1).to(tdt)
    fcol = torch.rand(N, generator=g, device=cuda) + 0.5
    a = torch.rand(M, generator=g, device=cuda) + 0.5
    cs = tuf.colsum(A)
    close(cs, tuf.colsum_plain(A), "float32")
    A1, A2 = A.clone(), A.clone()
    _, c1 = tuf.fused_iteration(A1, fcol, a, fi=0.9)
    _, c2 = tuf.fused_iteration_plain(A2, fcol, a, fi=0.9)
    close(A1, A2, dname)
    close(c1, c2, "float32")
    # the same launch twice gives the same bits
    A3 = A.clone()
    _, c3 = tuf.fused_iteration(A3, fcol, a, fi=0.9)
    assert torch.equal(A3, A1) and torch.equal(c3, c1)
    assert torch.equal(tuf.colsum(A), cs)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("B,M,N", [(8, 128, 384), (8, 100, 300),
                                   (3, 1, 7)])
@pytest.mark.parametrize("tol", [None, 1e-4])
def test_kernel_f_matches_plain_version(cuda, dname, B, M, N, tol):
    tdt = DTYPES[dname]
    K, a, b = (torch.tensor(x, device=cuda) for x in stack(B, M, N, M + N))
    kw = dict(fi=1.0 / 1.05, num_iters=200, tol=tol)
    A1, A2 = K.to(tdt, copy=True), K.to(tdt, copy=True)
    _, c1, i1, e1 = tur.resident_solve(A1, a, b, **kw)
    _, c2, i2, e2 = tur.resident_solve_plain(A2, a, b, **kw)
    close(A1, A2, dname, call=False)
    close(c1, c2, "float32", call=False)
    assert torch.equal(i1, i2)
    fin = torch.isfinite(e2)
    assert torch.equal(torch.isfinite(e1), fin)
    assert torch.allclose(e1[fin], e2[fin], rtol=1e-3, atol=DRIFT_ATOL)
    A3 = K.to(tdt, copy=True)
    _, c3, i3, e3 = tur.resident_solve(A3, a, b, **kw)
    assert torch.equal(A3, A1) and torch.equal(c3, c1)
    assert torch.equal(i3, i1) and torch.equal(e3, e1)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
def test_kernel_g_matches_plain_version(cuda, dname):
    tdt = DTYPES[dname]
    L, M, N = 8, 128, 384
    K, a, b = (torch.tensor(x, device=cuda) for x in stack(L, M, N, 3))
    iters = torch.tensor([0, 0, 5, 30, 0, 7, 0, 29], dtype=torch.int32,
                         device=cuda)
    conv = torch.tensor([0, 0, 0, 0, 1, 0, 0, 0], dtype=torch.bool,
                        device=cuda)
    active = torch.tensor([1, 0, 1, 1, 1, 1, 1, 1], dtype=torch.bool,
                          device=cuda)
    state = [K.to(tdt), K.float().sum(1), torch.ones(L, M, device=cuda),
             iters, conv]
    kw = dict(fi=1.0 / 1.05, n_iters=6, num_iters=30, tol=1e-4)
    s1 = [t.clone() for t in state]
    s2 = [t.clone() for t in state]
    tur.resident_stepped(*s1, active, a, b, **kw)
    tur.resident_stepped_plain(*s2, active, a, b, **kw)
    close(s1[0], s2[0], dname, call=False)
    for got, want in zip(s1[1:3], s2[1:3]):
        close(got, want, "float32", call=False)
    assert torch.equal(s1[3], s2[3]) and torch.equal(s1[4], s2[4])
    for lane in (1, 3, 4):                  # gate closed: untouched
        for t, t0 in zip(s1, state):
            assert torch.equal(t[lane], t0[lane])


def clouds(B, M, N, d, seed, device):
    """Point-cloud operands on the card, ragged valid counts (the first
    problem full), and marginals zero past them."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((B, M, d), generator=g, device=device)
    y = torch.rand((B, N, d), generator=g, device=device)
    mv = torch.full((B,), M, dtype=torch.int32, device=device)
    nv = torch.full((B,), N, dtype=torch.int32, device=device)
    mv[1:] = torch.randint(max(1, M // 2), M + 1, (B - 1,), generator=g,
                           device=device, dtype=torch.int32)
    nv[1:] = torch.randint(max(1, N // 2), N + 1, (B - 1,), generator=g,
                           device=device, dtype=torch.int32)
    rows = torch.arange(M, device=device)[None] < mv[:, None]
    cols = torch.arange(N, device=device)[None] < nv[:, None]
    a = (torch.rand((B, M), generator=g, device=device) + 0.5) * rows
    b = (torch.rand((B, N), generator=g, device=device) + 0.5) * cols
    a = a / a.sum(1, keepdim=True)
    b = b / b.sum(1, keepdim=True) * 1.3
    xn, yn = sq_norms(x), sq_norms(y)
    return (x, xn, y, yn, mv, nv), a, b


def ulps(got, want):
    """Largest distance in units in the last place between two tensors of
    non-negative values of one floating type."""
    itype = torch.int32 if got.dtype == torch.float32 else torch.int16
    return int((got.view(itype).long() - want.view(itype).long()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("B,M,N,d", [(3, 300, 1500, 2), (2, 77, 33, 3),
                                     (4, 128, 384, 9), (2, 9, 5000, 3)])
def test_kernels_h_i_j_match_plain_versions(cuda, dname, B, M, N, d):
    tdt = DTYPES[dname]
    ops_, a, _ = clouds(B, M, N, d, M + N + d, cuda)
    kw = dict(reg=0.05, scale=1.5)
    K = tug.batched_pc_materialize(*ops_, out_dtype=tdt, **kw)
    Kp = tug.batched_pc_materialize_plain(*ops_, out_dtype=tdt, **kw)
    assert K.dtype == tdt and ulps(K, Kp) <= J_ULPS[dname]
    mv, nv = ops_[4].tolist(), ops_[5].tolist()
    for k in range(B):
        assert (K[k, mv[k]:] == 0).all() and (K[k, :, nv[k]:] == 0).all()
    cs = tug.batched_pc_colsum(*ops_, storage_dtype=tdt, **kw)
    close(cs, tug.batched_pc_colsum_plain(*ops_, storage_dtype=tdt, **kw),
          "float32")
    g = torch.Generator(device=cuda).manual_seed(B)
    fcol = torch.rand((B, N), generator=g, device=cuda) + 0.5
    A1, c1, f1 = tug.batched_pc_first_iteration(fcol, a, *ops_, fi=0.9,
                                                out_dtype=tdt, **kw)
    A2, c2, f2 = tug.batched_pc_first_iteration_plain(
        fcol, a, *ops_, fi=0.9, out_dtype=tdt, **kw)
    close(A1, A2, dname)
    close(c1, c2, "float32")
    close(f1, f2, "float32")
    # repeated launches give the same bits
    assert torch.equal(tug.batched_pc_materialize(*ops_, out_dtype=tdt,
                                                  **kw), K)
    assert torch.equal(tug.batched_pc_colsum(*ops_, storage_dtype=tdt,
                                             **kw), cs)
    A3, c3, f3 = tug.batched_pc_first_iteration(fcol, a, *ops_, fi=0.9,
                                                out_dtype=tdt, **kw)
    assert torch.equal(A3, A1) and torch.equal(c3, c1) and torch.equal(f3, f1)
    # the dense twins over j's output: h is c, i is d (and e), bit for bit
    assert torch.equal(tub.batched_colsum(K), cs)
    Kd = K.clone()
    _, cd = tub.batched_fused_iteration(Kd, fcol, a, fi=0.9)
    assert torch.equal(Kd, A1) and torch.equal(cd, c1)
    Ke, live = K.clone(), torch.ones(B, dtype=torch.bool, device=cuda)
    _, ce, fe = tub.batched_fused_iteration_frow(
        Ke, fcol, a, live, torch.zeros((B, N), device=cuda), fi=0.9)
    assert torch.equal(Ke, A1) and torch.equal(ce, c1)
    assert torch.equal(fe, f1)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("B,M,N,d", [(8, 128, 384, 2), (8, 100, 300, 3),
                                     (3, 31, 200, 9)])
@pytest.mark.parametrize("tol", [None, 1e-4])
def test_kernel_k_matches_plain_version_and_f(cuda, dname, B, M, N, d, tol):
    tdt = DTYPES[dname]
    ops_, a, b = clouds(B, M, N, d, M + N, cuda)
    kw = dict(fi=1.0 / 1.05, num_iters=200, tol=tol)
    gk = dict(reg=0.05, scale=1.0)
    P, cs, it, err = tur.resident_solve_pc(*ops_[:4], a, b, *ops_[4:],
                                           out_dtype=tdt, **gk, **kw)
    Pp, csp, itp, errp = tur.resident_solve_pc_plain(
        *ops_[:4], a, b, *ops_[4:], out_dtype=tdt, **gk, **kw)
    close(P, Pp, dname, call=False)
    close(cs, csp, "float32", call=False)
    assert torch.equal(it, itp)
    fin = torch.isfinite(errp)
    assert torch.equal(torch.isfinite(err), fin)
    assert torch.allclose(err[fin], errp[fin], rtol=1e-3, atol=DRIFT_ATOL)
    # repeated launches, and f over j's output: the same bits
    P2, cs2, it2, err2 = tur.resident_solve_pc(*ops_[:4], a, b, *ops_[4:],
                                               out_dtype=tdt, **gk, **kw)
    K = tug.batched_pc_materialize(*ops_, out_dtype=tdt, **gk)
    Pf, csf, itf, errf = tur.resident_solve(K, a, b, **kw)
    for got in ((P2, cs2, it2, err2), (Pf, csf, itf, errf)):
        assert all(torch.equal(u, v) for u, v in zip(got, (P, cs, it, err)))


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("B,M,N", [(3, 1500, 2047), (2, 300, 1504),
                                   (1, 9, 16384), (4, 77, 33)])
@pytest.mark.parametrize("fi", [1.0, 0.9])
def test_kernels_n_o_match_plain_versions(cuda, dname, B, M, N, fi):
    tdt = DTYPES[dname]
    K, a, _ = (torch.tensor(x, device=cuda) for x in stack(B, M, N, M + N))
    K = K.to(tdt)
    g = torch.Generator(device=cuda).manual_seed(N)
    v = torch.rand((B, N), generator=g, device=cuda) + 0.5
    u, ktu = tub.batched_uv_iteration(K, v, a, fi=fi)
    u_p, ktu_p = tub.batched_uv_iteration_plain(K, v, a, fi=fi)
    close(u, u_p, "float32")
    close(ktu, ktu_p, "float32")
    u2, ktu2 = tub.batched_uv_iteration(K, v, a, fi=fi)
    assert torch.equal(u2, u) and torch.equal(ktu2, ktu)
    for out in DTYPES.values():
        P = tub.batched_materialize_coupling(K, u, v, out_dtype=out)
        assert P.dtype == out and torch.equal(
            P, tub.batched_materialize_coupling_plain(K, u, v,
                                                      out_dtype=out))


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("M,N", [(4096, 4096), (1500, 2047), (77, 33)])
def test_kernels_l_m_match_plain_versions(cuda, dname, M, N):
    tdt = DTYPES[dname]
    K, a, _ = (torch.tensor(x[0], device=cuda)
               for x in stack(1, M, N, M * N))
    K = K.to(tdt)
    g = torch.Generator(device=cuda).manual_seed(M)
    v = torch.rand(N, generator=g, device=cuda) + 0.5
    u, ktu = tuv.uv_iteration(K, v, a, fi=0.9)
    u_p, ktu_p = tuv.uv_iteration_plain(K, v, a, fi=0.9)
    close(u, u_p, "float32")
    close(ktu, ktu_p, "float32")
    P = tuv.materialize_coupling(K, u, v)
    assert torch.equal(P, tuv.materialize_coupling_plain(K, u, v))
    assert torch.equal(tuv.materialize_coupling(K, u, v), P)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", list(DTYPES))
def test_solve_uv_paths_match_plain_iterates(cuda, dname):
    from repro_torch.core import UOTConfig
    from repro_torch.core.problem import rescale_factors
    from repro_torch.core.sinkhorn_uv import sinkhorn_uot_uv_fused
    from repro_torch.kernels import ops
    tdt = DTYPES[dname]
    cfg = UOTConfig(reg=0.1, reg_m=1.0, num_iters=20)
    K, a, b = (torch.tensor(x, device=cuda) for x in stack(3, 300, 500, 4))
    K = K.to(tdt)
    for k in range(3):
        tuv.reset_counts()
        P, (u, v) = ops.solve_uv(K[k], a[k], b[k], cfg)
        assert tuv.LAUNCHES == {"uv_iteration": 21,
                                "materialize_coupling": 1}
        assert not any(tuv.PLAIN_CALLS.values())
        _, (_, v_p), _ = sinkhorn_uot_uv_fused(K[k], a[k], b[k], cfg)
        Kf = K[k].float()
        u_p = rescale_factors(a[k], Kf @ v_p, cfg.fi)
        close_rel(v, v_p, 3e-5)
        close_rel(u, u_p, 3e-5)
        close_rel(P, u_p[:, None] * Kf * v_p[None, :], 3e-4)
    tub.reset_counts()
    P, (u, v) = ops.solve_uv_batched(K, a, b, cfg)
    assert tub.LAUNCHES["batched_uv_iteration"] == 21
    assert tub.LAUNCHES["batched_materialize_coupling"] == 1
    for k in range(3):
        Pk, (uk, vk) = ops.solve_uv(K[k], a[k], b[k], cfg)
        close_rel(P[k], Pk, 3e-4)
        close_rel(v[k], vk, 3e-5)


def close_rel(got, want, rtol):
    """Per entry, rtol of the value plus the subnormal slack of
    ``close``."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert got.shape == want.shape
    top = np.abs(want).max()
    bad = np.abs(got - want) > rtol * np.abs(want) + TINY + FLOOR * top
    assert not bad.any(), (int(bad.sum()), want.size)
