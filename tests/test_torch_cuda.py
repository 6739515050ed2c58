"""The port's CUDA kernels a, b, f and g against their plain versions on
the card (all tests carry the ``cuda`` marker and skip without a card).

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
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import uot_fused as tuf
from repro_torch.kernels import uot_resident as tur

F32_CALL = 1e-5       # one kernel call, fp32
F32_SOLVE = 3e-5      # a whole resident solve, fp32
BF16_ULP = 2.0 ** -7  # one bf16 rounding
TINY, FLOOR = 1e-37, 2.0 ** -100
BF16_POINT, BF16_MASS = 5e-2, 1e-2
DRIFT_ATOL = 1e-6     # final drifts: a difference of factors near 1
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
