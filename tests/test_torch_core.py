"""PyTorch port, core semantics: the same numpy inputs through the JAX
reference (``repro.core``) and the port (``repro_torch.core``) on the CPU.

Tolerances: fp32 whole solves agree to relative 1e-4 (summation order
differs between XLA and PyTorch); iteration counts under ``tol`` are equal
on problems whose drift clears tol by a margin. Also here: the rule that
the port imports nothing of JAX or of the reference (checked by parsing
the sources), and the rule that entry points default to the card and
raise without CUDA.
"""
import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import health as jhealth
from repro.core import problem as jproblem
from repro_torch import core as tcore
from repro_torch import convert, obs as tobs
from repro_torch.core import health as thealth
from repro_torch.kernels import ops as tops
from repro_torch.serve import UOTBatchEngine, UOTScheduler

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL_SOLVE = 1e-4


def problem(M, N, seed, reg=0.1, peak=1.0, mass_b=1.2):
    rng = np.random.default_rng(seed)
    C = rng.uniform(0, 1, size=(M, N)).astype(np.float32) * peak
    a = rng.uniform(0.5, 1.5, size=M).astype(np.float32)
    b = rng.uniform(0.5, 1.5, size=N).astype(np.float32)
    a, b = a / a.sum(), b / b.sum() * mass_b
    K = (np.exp(-C / reg) * (a[:, None] * b[None, :])).astype(np.float32)
    return K, a, b, C


def cfg_pair(**kw):
    return jcore.UOTConfig(**kw), tcore.UOTConfig(**kw)


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


class TestProblem:
    @pytest.mark.parametrize("reg_m", [1.0, float("inf")])
    def test_rescale_factors_and_fi(self, reg_m):
        jc, tc = cfg_pair(reg=0.1, reg_m=reg_m)
        assert jc.fi == tc.fi
        rng = np.random.default_rng(0)
        t = rng.uniform(0, 2, 64).astype(np.float32)
        s = rng.uniform(0, 2, 64).astype(np.float32)
        s[::7] = 0.0            # the 0-sum guard maps these to factor 1
        want = np.asarray(jproblem.rescale_factors(jnp.asarray(t),
                                                jnp.asarray(s), tc.fi))
        got = tcore.rescale_factors(torch.tensor(t), torch.tensor(s),
                                    tc.fi).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert np.all(got[::7] == 1.0)

    def test_gibbs_and_cost(self):
        K, a, b, C = problem(12, 20, 1)
        np.testing.assert_allclose(
            tcore.gibbs_kernel(torch.tensor(C), 0.1).numpy(),
            np.asarray(jcore.gibbs_kernel(jnp.asarray(C), 0.1)), rtol=1e-6)
        want = float(jcore.uot_cost(jnp.asarray(K), jnp.asarray(C),
                                    jnp.asarray(a), jnp.asarray(b), 0.1, 1.0))
        got = float(tcore.uot_cost(torch.tensor(K), torch.tensor(C),
                                   torch.tensor(a), torch.tensor(b), 0.1, 1.0))
        assert got == pytest.approx(want, rel=1e-5)

    def test_dense_problem_only(self):
        K, a, b, C = problem(5, 6, 2)
        p = tcore.UOTProblem.from_cost(C, a, b)
        assert p.shape == (5, 6)
        with pytest.raises(NotImplementedError, match="geometry"):
            tcore.UOTProblem.from_points(None, None, a, b)


class TestPlainSolvers:
    @pytest.mark.parametrize("tol", [None, 1e-5])
    def test_fused_and_baseline_match_reference(self, tol):
        K, a, b, _ = problem(24, 40, 3)
        jc, tc = cfg_pair(reg=0.1, reg_m=1.0, num_iters=30, tol=tol)
        Pj, sj = jcore.sinkhorn_uot_fused(jnp.asarray(K), jnp.asarray(a),
                                          jnp.asarray(b), jc)
        Pt, st = tcore.sinkhorn_uot_fused(torch.tensor(K), torch.tensor(a),
                                          torch.tensor(b), tc)
        assert rel(Pt, Pj) <= RTOL_SOLVE
        assert st["iters"] == int(sj["iters"])
        Pb, sb = tcore.sinkhorn_uot_baseline(torch.tensor(K), torch.tensor(a),
                                             torch.tensor(b), tc)
        assert rel(Pb, Pj) <= RTOL_SOLVE
        assert sb["iters"] == int(sj["iters"])

    def test_batched_per_lane_early_exit(self):
        probs = [problem(16, 32, s, peak=p) for s, p in ((4, 1.0), (5, 6.0))]
        K = np.stack([p[0] for p in probs])
        a = np.stack([p[1] for p in probs])
        b = np.stack([p[2] for p in probs])
        jc, tc = cfg_pair(reg=0.1, reg_m=1.0, num_iters=30, tol=1e-5)
        Pj, sj = jcore.sinkhorn_uot_fused_batched(
            jnp.asarray(K), jnp.asarray(a), jnp.asarray(b), jc)
        Pt, st = tcore.sinkhorn_uot_fused_batched(
            torch.tensor(K), torch.tensor(a), torch.tensor(b), tc)
        assert rel(Pt, Pj) <= RTOL_SOLVE
        np.testing.assert_array_equal(st["iters"].numpy(),
                                      np.asarray(sj["iters"]))

    @pytest.mark.parametrize("ti", [False, True])
    def test_log_domain_matches_reference(self, ti):
        _, a, b, C = problem(16, 24, 6, mass_b=2.0)
        jc, tc = cfg_pair(reg=0.1, reg_m=1.0, num_iters=60, tol=1e-6,
                          translation_invariant=ti)
        Pj, _, sj = jcore.sinkhorn_uot_log(jnp.asarray(C), jnp.asarray(a),
                                           jnp.asarray(b), jc)
        Pt, _, st = tcore.sinkhorn_uot_log(torch.tensor(C), torch.tensor(a),
                                           torch.tensor(b), tc)
        assert rel(Pt, Pj) <= RTOL_SOLVE
        assert abs(st["iters"] - int(sj["iters"])) <= 1


class TestHealth:
    @pytest.mark.parametrize("case", ["ok", "nan", "neg", "empty", "shape",
                                      "overflow"])
    def test_validate_reasons_match(self, case):
        _, a, b, _ = problem(6, 8, 7)
        cfg_kw = dict(reg=0.1, reg_m=1.0)
        shape = (6, 8)
        if case == "nan":
            a = a.copy(); a[2] = np.nan
        elif case == "neg":
            b = b.copy(); b[0] = -1.0
        elif case == "empty":
            a = np.zeros_like(a)
        elif case == "shape":
            shape = (6, 9)
        elif case == "overflow":
            cfg_kw = dict(reg=0.001, reg_m=10.0)
            b = b * 5.0
        jc, tc = cfg_pair(**cfg_kw)
        reasons = []
        for mod, c in ((jhealth, jc), (thealth, tc)):
            try:
                mod.validate_problem(c, a, b, shape=shape, rid=3)
                reasons.append(None)
            except mod.InvalidProblemError as err:
                assert err.rid == 3
                reasons.append(err.reason)
        assert reasons[0] == reasons[1]
        assert (reasons[1] is None) == (case == "ok")

    def test_escalate_log_solve_matches_reference(self):
        K, a, b, _ = problem(10, 14, 8)
        jc, tc = cfg_pair(reg=0.1, reg_m=1.0, num_iters=20)
        Pj, sj, okj = jhealth.escalate_log_solve(K, a, b, jc)
        Pt, st, okt = thealth.escalate_log_solve(K, a, b, tc, device="cpu")
        assert okj and okt and st["num_iters"] == sj["num_iters"] == 40
        assert rel(Pt, Pj) <= RTOL_SOLVE
        Kbad = K.copy(); Kbad[1, 1] = np.nan
        assert not thealth.escalate_log_solve(Kbad, a, b, tc,
                                              device="cpu")[2]
        assert thealth.escalation_config(tc).dtype == torch.float32

    def test_predictor_copy_agrees(self):
        jc, tc = cfg_pair(reg=0.1, reg_m=1.0, num_iters=200, tol=1e-4)
        for ma, mb in ((1.0, 1.0), (1.0, 3.0)):
            assert (tcore.analytic_iters(tc, ma, mb)
                    == jcore.analytic_iters(jc, ma, mb))


class TestConvert:
    def test_config_from_fields(self):
        c = convert.config_from_fields(0.05, 2.0, 40, 1e-4, "bfloat16", True)
        assert c == tcore.UOTConfig(reg=0.05, reg_m=2.0, num_iters=40,
                                    tol=1e-4, dtype=torch.bfloat16,
                                    translation_invariant=True)
        with pytest.raises(ValueError):
            convert.config_from_fields(0.05, 2.0, 40, None, "float16")

    def test_trim_refuses_live_entries(self):
        st = tops.make_lane_state(2, 8, 16, tcore.UOTConfig(), device="cpu")
        st.P[0, 7, 3] = 1.0
        arrays = convert.lane_state_to_numpy(st, M=16, N=128)
        assert arrays["P"].shape == (2, 16, 128)
        assert np.all(arrays["frow"][:, 8:] == 1.0)
        back = convert.lane_state_from_numpy(arrays, "cpu", M=8, N=16)
        assert torch.equal(back.P, st.P)
        with pytest.raises(ValueError, match="not padding"):
            convert.lane_state_from_numpy(arrays, "cpu", M=7, N=16)


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_the_reference():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert _port_sources()[-1].exists()
    assert not offenders, offenders


@pytest.mark.parametrize("entry", ["scheduler", "engine", "lane_state",
                                   "batched", "bucketed", "escalate",
                                   "fused", "fused_auto", "resident"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcore.UOTConfig(num_iters=2)
    K, a, b, _ = problem(4, 6, 9)
    calls = {
        "scheduler": lambda: UOTScheduler(cfg),
        "engine": lambda: UOTBatchEngine(cfg),
        "lane_state": lambda: tops.make_lane_state(2, 4, 6, cfg),
        "batched": lambda: tops.solve_fused_batched(K[None], a[None],
                                                    b[None], cfg),
        "bucketed": lambda: tops.solve_fused_bucketed([(K, a, b)], cfg),
        "escalate": lambda: thealth.escalate_log_solve(K, a, b, cfg),
        "fused": lambda: tops.solve_fused(K, a, b, cfg),
        "fused_auto": lambda: tops.solve_fused(K, a, b, cfg, impl="auto"),
        "resident": lambda: tops.solve_fused_resident(K, a, b, cfg),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_observability_bundle():
    ob = tobs.Observability(chain=False)
    assert not ob.traffic.enabled and not ob.flight.enabled
    assert ob.attach_operational(slos=()) is ob
    with pytest.raises(NotImplementedError, match="observability slice"):
        ob.attach_operational(slos=[object()])
    ob.registry.counter("serve.completed").inc(2)
    assert ob.dump()["registry"]["counters"]["serve.completed"] == 2


def test_config_is_hashable_dataclass():
    c = tcore.UOTConfig(dtype=torch.bfloat16)
    assert hash(c) == hash(dataclasses.replace(c))
