#!/usr/bin/env python3
"""Drive the PyTorch port of MAP-UOT (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port starts on the card. It

1. prints the card (``nvidia-smi``), the torch / CUDA / nvcc versions, and
   builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all started together; timed);
2. holds kernels c, d, e (``batched_colsum``, ``batched_fused_iteration``,
   ``batched_fused_iteration_frow``) against their plain PyTorch versions
   on the card, fp32 and bf16, at ragged and wide shapes; frozen lanes and
   repeated launches must be bitwise equal;
3. drives the serving path of the first slice with the launch counters
   zeroed just before and read just after: ``solve_fused_batched`` (B=1
   4096x4096 and B=8 2048x2048, tol None and 1e-4), a ``UOTBatchEngine``
   flush of 32 ragged requests, and ``UOTScheduler`` runs of 64 requests
   arriving over time (pools of 8 lanes, fp32 and bf16). Kernels c, d, e
   must have launched, and no plain version may have run;
4. checks every result against plain solves on the card;
5. times kernels c, d, e with CUDA events beside their bound, their plain
   version and the one PyTorch call that computes the same function (if
   any); each timed call takes the next of several input copies that
   together span three times the L2, so it reads device memory;
6. traces a scheduler run with ``torch.profiler``: device-busy share and
   the top device operations;
7. holds kernels a, b (``colsum``, ``fused_iteration``) and f, g
   (``resident_solve``, ``resident_stepped``) against their plain versions:
   a, b at 4096x4096 and 8192x8192; f at B=256 and B=8 128x384 and a
   ragged B=8 100x300, tol None and 1e-4 (iteration counts equal); g on a
   32-lane pool mixing free, finished, unhealthy and live lanes (closed
   lanes bitwise untouched); fp32 and bf16, every entry held relative to
   its own value (see ``each``), repeated launches bitwise;
8. drives the second slice's path with the counters zeroed just before
   and read just after: ``solve_fused`` (4096x4096 fp32 and bf16, and
   ``impl='auto'`` over budget), ``solve_fused(impl='auto')`` at 128x384,
   ``solve_fused_batched(impl='resident')`` at B=256 128x384, and a
   ``UOTScheduler(impl='auto')`` run of 64 small and 16 large requests in
   which both dispatch counters must move. All seven kernels must have
   launched, no plain version may have run, and every result is held
   against plain solves on the card (iteration counts equal);
9. times kernels a, b, f, g as in 5, and the scheduler's small requests on
   the resident route against the streamed route;
10. holds the point-cloud kernels h, i, j, k (``batched_pc_colsum``,
    ``batched_pc_first_iteration``, ``batched_pc_materialize``,
    ``resident_solve_pc``) against their plain versions at ragged shapes,
    d = 2, 3 and 9, fp32 and bf16 (j within 2 ulps per entry, masked
    regions exactly zero, repeated launches bitwise), and the pairs that
    must agree bit for bit inside the port: h = c, i = d and k = f over
    j's output, and the engine and scheduler point paths against dense
    submission of ``geometry.kernel()``;
11. drives the third slice's path with the counters zeroed just before and
    read just after: ``solve_fused_batched(geometry=)`` at B=8 2048x2048
    d=3 (fp32, tol None and 1e-4; bf16), ``solve_fused(geometry=)`` at
    4096x4096, ``solve_fused_resident(geometry=)`` and
    ``solve_fused_batched(geometry=, impl='auto')`` at B=256 128x384 d=2,
    a ``UOTBatchEngine(impl='auto')`` flush of 32 point requests, and
    ``UOTScheduler`` runs of 64 point requests (fp32, bf16) and of 80 point
    and 16 dense requests with ``impl='auto'``. Kernels h, i, j, k must
    have launched and no plain version may have run; every result is held
    against plain solves on the card (iteration counts equal);
12. times h, i, j, k as in 5, and prints the end-to-end time of a B=8
    2048x2048 ``solve_fused_batched`` from host numpy with ``geometry=``
    and dense from the host-materialized kernel (a line, not a claim);
13. (the result lines, last: see 17);
14. holds the u/v kernels l, m, n, o (``uv_iteration``,
    ``materialize_coupling``, ``batched_uv_iteration``,
    ``batched_materialize_coupling``) against their plain versions: l, m
    at 4096x4096, n, o at B=8 2048x2048 and a ragged B=3 1500x2047 (odd N:
    vector width 1), fp32 and bf16 K, fi 0.95 and 1.0; l, n per entry of u
    and K^T u within F32_RTOL, m, o bit for bit, repeated launches bitwise;
15. drives the fourth slice's path with the counters zeroed just before
    and read just after: ``solve_uv`` at 4096x4096 (fp32 and bf16 K,
    materialize True and False) and 8192x8192 fp32, ``solve_uv_batched``
    at B=8 2048x2048 (fp32 and bf16 K, impl None and 'kernel'), 20
    iterations. Kernels l, m, n, o must have launched and no plain version
    may have run; every result is held per entry against the plain u/v
    iterates on the card (``sinkhorn_uot_uv_fused``'s v, and u one plain
    half-iteration further, as ``solve_uv`` takes it): u, v 3e-5, P 3e-4;
16. times l, m, n, o as in 5, the cuBLAS pair ``K @ v`` / ``u @ K`` at
    n's shape as context, and ``solve_uv_batched`` against
    ``solve_fused_batched`` at B=8 2048x2048 (a line, not a claim);
17. prints a ``{"kernels": [...]}`` line for all fifteen kernels, the
    card's name and power limit, and last ``{"ok": true, "device":
    {...}}``.

Any failed check raises, and the script exits non-zero without a result:
also when CUDA is not available or the package is not beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2
F32_RTOL = 1e-5                  # one kernel call, fp32, per entry
SOLVE_RTOL = 1e-4                # whole solves, fp32
EACH_RTOL = 3e-5                 # whole resident solves, fp32, per entry
UV_RTOL, P_RTOL = 3e-5, 3e-4     # u/v solves per entry: u, v and P (the
                                 # reference's bars, tests/test_kernels.py)
TINY = 1e-37                     # absolute slack of per-entry checks (the
FLOOR = 2.0 ** -100              # fp32 subnormal range), plus FLOOR of the
                                 # largest entry of the problem: entries
                                 # that small passed through the subnormal
                                 # range, where one product rounds coarser
                                 # than rtol; the median entry of a Gibbs
                                 # coupling here is 1e-26 of the largest
BF16_ULP = 2.0 ** -7             # one bf16 rounding apart, per entry
BF16_POINT, BF16_MASS = 5e-2, 1e-2
DRIFT_ATOL = 1e-6                # final drifts: 8 ulps of a factor near 1
CSRC = "src/repro_torch/kernels/csrc/"
# kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "colsum": ("uot_fused.cu", "src/repro/kernels/uot_fused.py:132"),
    "fused_iteration": ("uot_fused.cu", "src/repro/kernels/uot_fused.py:83"),
    "batched_colsum": ("uot_batched.cu",
                       "src/repro/kernels/uot_batched.py:194"),
    "batched_fused_iteration": ("uot_batched.cu",
                                "src/repro/kernels/uot_batched.py:66"),
    "batched_fused_iteration_frow": ("uot_batched.cu",
                                     "src/repro/kernels/uot_batched.py:132"),
    "resident_solve": ("uot_resident.cu",
                       "src/repro/kernels/uot_resident.py:140"),
    "resident_stepped": ("uot_resident.cu",
                         "src/repro/kernels/uot_resident.py:383"),
    "batched_pc_colsum": ("uot_geometry.cu",
                          "src/repro/kernels/uot_geometry.py:155"),
    "batched_pc_first_iteration": ("uot_geometry.cu",
                                   "src/repro/kernels/uot_geometry.py:212"),
    "batched_pc_materialize": ("uot_geometry.cu",
                               "src/repro/kernels/uot_geometry.py:112"),
    "resident_solve_pc": ("uot_resident.cu",
                          "src/repro/kernels/uot_resident.py:212"),
    "uv_iteration": ("uot_uv_fused.cu",
                     "src/repro/kernels/uot_uv_fused.py:52"),
    "materialize_coupling": ("uot_uv_fused.cu",
                             "src/repro/kernels/uot_uv_fused.py:90"),
    "batched_uv_iteration": ("uot_batched.cu",
                             "src/repro/kernels/uot_batched.py:230"),
    "batched_materialize_coupling": ("uot_batched.cu",
                                     "src/repro/kernels/uot_batched.py:268"),
}
# the kernels of the first slice (the serving main path)
FIRST = {"batched_colsum", "batched_fused_iteration",
         "batched_fused_iteration_frow"}
# the kernels of the third slice (point-cloud geometries)
THIRD = {"batched_pc_colsum", "batched_pc_first_iteration",
         "batched_pc_materialize", "resident_solve_pc"}
# the kernels of the fourth slice (the u/v potential form)
FOURTH = {"uv_iteration", "materialize_coupling", "batched_uv_iteration",
          "batched_materialize_coupling"}


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import UOTConfig
    from repro_torch.core.sinkhorn_fused import (sinkhorn_uot_fused,
                                                 sinkhorn_uot_fused_batched)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import uot_batched as ub
    from repro_torch.kernels import uot_fused as uf
    from repro_torch.kernels import uot_resident as ur
    from repro_torch.serve import UOTBatchEngine, UOTScheduler

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader", "-i", "0"])
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    log("device", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvcc {nvcc} | "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    log("build", f"{_build.BUILD_INFO['path']} built={_build.BUILD_INFO['built']}"
        f" in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rel(x, y):
        x, y = x.float(), y.float()
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))

    def each(got, want, rtol, what):
        """Per entry: |got - want| <= rtol * |want| + TINY + FLOOR * (the
        largest |want| of its problem: the leading axis of a stack). Returns
        the largest relative error over the entries above that slack."""
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        top = (want.abs().amax(dim=(-2, -1), keepdim=True)
               if want.dim() == 3 else want.abs().max())
        slack = TINY + FLOOR * top
        bad = int((diff > slack + rtol * want.abs()).sum())
        big = want.abs() > slack
        worst = float((diff[big] / want.abs()[big]).max()) if bool(
            big.any()) else 0.0
        check(bad == 0 and torch.equal(torch.isfinite(got),
                                       torch.isfinite(want)),
              f"{what}: {bad} of {want.numel()} entries off by more than "
              f"{rtol:.3g} of their value (worst {worst:.3g})")
        return worst

    def within(got, want, dtype, what, *, call=True):
        """``call``: one kernel call against its plain version, both
        rounding once: per entry, F32_RTOL fp32 or one bf16 rounding, and
        for bf16 the pointwise / mass bars too. Otherwise a whole solve:
        SOLVE_RTOL of the largest entry fp32, the pointwise / mass bars
        bf16 (solves held per entry call ``each`` themselves). Returns the
        max abs error."""
        got, want = got.float(), want.float()
        if dtype == torch.bfloat16:
            point = float((got - want).abs().max() / want.abs().max())
            mass = abs(float(got.sum() - want.sum())) / abs(float(want.sum()))
            check(point <= BF16_POINT and mass <= BF16_MASS,
                  f"{what}: bf16 pointwise {point:.3g} mass {mass:.3g}")
            if call:
                each(got, want, BF16_ULP, what)
        elif call:
            each(got, want, F32_RTOL, what)
        else:
            check(rel(got, want) <= SOLVE_RTOL,
                  f"{what}: rel err {rel(got, want):.3g}")
        return float((got - want).abs().max())

    # ---- 2. kernels against their plain versions ---------------------------
    errs = {}
    for (B, M, N) in [(8, 2048, 2048), (8, 1000, 1500), (2, 256, 16384)]:
        for dt in (torch.float32, torch.bfloat16):
            A = (torch.rand((B, M, N), generator=gen, device=dev) + 0.1).to(dt)
            fcol = torch.rand((B, N), generator=gen, device=dev) + 0.5
            a = torch.rand((B, M), generator=gen, device=dev) + 0.5
            carried = torch.rand((B, N), generator=gen, device=dev)
            mask = torch.arange(B, device=dev) % 2 == 0
            cs, cs_p = ub.batched_colsum(A), ub.batched_colsum_plain(A)
            e_c = within(cs, cs_p, dt, f"colsum {B}x{M}x{N}")
            A1, A2 = A.clone(), A.clone()
            _, c1 = ub.batched_fused_iteration(A1, fcol, a, fi=0.95)
            _, c2 = ub.batched_fused_iteration_plain(A2, fcol, a, fi=0.95)
            e_d = max(within(A1, A2, dt, f"fused {B}x{M}x{N}"),
                      within(c1, c2, dt, f"fused colsum {B}x{M}x{N}"))
            A3, A4 = A.clone(), A.clone()
            k3, k4 = carried.clone(), carried.clone()
            _, _, f3 = ub.batched_fused_iteration_frow(A3, fcol, a, mask, k3,
                                                       fi=0.95)
            _, _, f4 = ub.batched_fused_iteration_frow_plain(
                A4, fcol, a, mask, k4, fi=0.95)
            e_e = max(within(A3, A4, dt, f"frow {B}x{M}x{N}"),
                      within(k3, k4, dt, f"frow colsum {B}x{M}x{N}"),
                      within(f3[mask], f4[mask], dt, f"frow {B}x{M}x{N}"))
            check(torch.equal(A3[~mask], A[~mask])
                  and torch.equal(k3[~mask], carried[~mask]),
                  f"frozen lanes changed at {B}x{M}x{N} {dt}")
            A5, k5 = A.clone(), carried.clone()
            _, _, f5 = ub.batched_fused_iteration_frow(A5, fcol, a, mask, k5,
                                                       fi=0.95)
            A6 = A.clone()
            _, c6 = ub.batched_fused_iteration(A6, fcol, a, fi=0.95)
            check(torch.equal(A5, A3) and torch.equal(k5, k3)
                  and torch.equal(f5[mask], f3[mask]) and torch.equal(A6, A1)
                  and torch.equal(c6, c1)
                  and torch.equal(ub.batched_colsum(A), cs),
                  f"repeat launch not bitwise at {B}x{M}x{N} {dt}")
            plan = ub.plan_for(B, M, N, A.element_size())
            log("kernels", f"{B}x{M}x{N} {str(dt)[6:]} {plan.variant} "
                f"block_m={plan.block_m} rows/cta={plan.rows_per_cta} "
                f"ctas={plan.ctas} vec={plan.vec} smem={plan.smem_bytes} | "
                f"max abs err c {e_c:.3g} d {e_d:.3g} e {e_e:.3g} | "
                f"frozen=bitwise repeat=bitwise")
            if (B, M, N) == (8, 2048, 2048) and dt == torch.float32:
                errs = {"batched_colsum": e_c,
                        "batched_fused_iteration": e_d,
                        "batched_fused_iteration_frow": e_e}
            del A, A1, A2, A3, A4, A5, A6
    torch.cuda.synchronize()

    # ---- problems -----------------------------------------------------------
    def stacks(B, M, N, reg, peak_lo=1.0, peak_hi=6.0):
        peak = peak_lo + (peak_hi - peak_lo) * torch.rand(
            (B, 1, 1), generator=gen, device=dev)
        C = torch.rand((B, M, N), generator=gen, device=dev) * peak
        a = torch.rand((B, M), generator=gen, device=dev) + 0.5
        b = torch.rand((B, N), generator=gen, device=dev) + 0.5
        a = a / a.sum(1, keepdim=True)
        b = b / b.sum(1, keepdim=True) * 1.2
        K = torch.exp(-C / reg) * a[:, :, None] * b[:, None, :]
        return K, a, b

    def host_problems(n, lo, hi, reg):
        sizes = torch.randint(lo, hi + 1, (n, 2), generator=gen, device=dev)
        out = []
        for M, N in sizes.tolist():
            K, a, b = stacks(1, M, N, reg)
            out.append((K[0].cpu().numpy(), a[0].cpu().numpy(),
                        b[0].cpu().numpy()))
        return out

    reg = 0.05
    cfg_fixed = UOTConfig(reg=reg, reg_m=1.0, num_iters=20)
    cfg_tol = UOTConfig(reg=reg, reg_m=1.0, num_iters=100, tol=1e-4)
    batched_inputs = {(B, M): stacks(B, M, M, reg)
                      for B, M in ((1, 4096), (8, 2048))}
    flush_reqs = host_problems(32, 1500, 2048, reg)
    sched_reqs = {dt: host_problems(64, 1500, 2048, reg)
                  for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()

    def serve(dt, reqs, *, waves=8):
        """64 requests in waves between scheduler rounds, deadlines 1 s
        after arrival; returns (scheduler, results, wall seconds)."""
        sched = UOTScheduler(UOTConfig(reg=reg, reg_m=1.0, num_iters=100,
                                       tol=1e-4, dtype=dt),
                             lanes_per_pool=8, chunk_iters=4, m_bucket=512,
                             n_bucket=512)
        per = len(reqs) // waves
        out = {}
        t0 = time.perf_counter()
        for w in range(waves):
            for K, a, b in reqs[w * per:(w + 1) * per]:
                sched.submit(K, a, b, deadline=time.monotonic() + 1.0)
            out.update(sched.step())
        out.update(sched.run())
        return sched, out, time.perf_counter() - t0

    # ---- 3. the main path, counted ------------------------------------------
    ub.reset_counts()
    batched_out = {}
    for (B, M), (K, a, b) in batched_inputs.items():
        for cfg in (cfg_fixed, cfg_tol):
            t0 = time.perf_counter()
            P, colsum = ops.solve_fused_batched(K, a, b, cfg)
            torch.cuda.synchronize()
            batched_out[(B, M, cfg.tol)] = (P, colsum,
                                            time.perf_counter() - t0)
    engine = UOTBatchEngine(cfg_tol, m_bucket=512, n_bucket=512)
    rids = [engine.submit(K, a, b) for K, a, b in flush_reqs]
    t0 = time.perf_counter()
    flushed = engine.flush()
    t_flush = time.perf_counter() - t0
    served = {dt: serve(dt, reqs) for dt, reqs in sched_reqs.items()}
    torch.cuda.synchronize()
    launches = dict(ub.LAUNCHES)
    plain_calls = dict(ub.PLAIN_CALLS)
    log("launches", f"main path {launches}; plain versions {plain_calls}")
    check(all(launches[k] > 0 for k in FIRST),
          f"a kernel of the main path never launched: {launches}")
    check(not any(plain_calls.values()),
          f"a plain version ran on the card path: {plain_calls}")

    # ---- 4. results against plain solves on the card ------------------------
    for (B, M, tol), (P, colsum, dt_s) in batched_out.items():
        K, a, b = batched_inputs[(B, M)]
        cfg = cfg_tol if tol is not None else cfg_fixed
        Pp, st = sinkhorn_uot_fused_batched(K, a, b, cfg)
        check(bool(torch.isfinite(P).all()) and P.shape == (B, M, M),
              "solve_fused_batched output not finite / wrong shape")
        within(P, Pp, torch.float32, f"solve_fused_batched B={B} {M}x{M} "
               f"tol={tol}", call=False)
        log("solve_fused_batched", f"B={B} {M}x{M} fp32 tol={tol}: "
            f"{dt_s * 1e3:.1f} ms, rel err vs plain {rel(P, Pp):.3g}, "
            f"plain iters {st['iters'].tolist()}")
        del Pp

    def plain_single(K, a, b):
        cfg = UOTConfig(reg=reg, reg_m=1.0, num_iters=100, tol=1e-4)
        P, st = sinkhorn_uot_fused(torch.as_tensor(K, device=dev),
                                   torch.as_tensor(a, device=dev),
                                   torch.as_tensor(b, device=dev), cfg)
        return P, st["iters"]

    check(sorted(flushed) == rids, "flush lost requests")
    worst = 0.0
    for rid, (K, a, b) in zip(rids, flush_reqs):
        P = torch.as_tensor(flushed[rid], device=dev)
        Pp, _ = plain_single(K, a, b)
        check(P.shape == Pp.shape, "flush result shape")
        within(P, Pp, torch.float32, f"flush rid {rid}", call=False)
        worst = max(worst, rel(P, Pp))
    log("engine", f"UOTBatchEngine flush of {len(rids)} ragged requests "
        f"(1500-2048 per side) in {t_flush * 1e3:.1f} ms, worst rel err vs "
        f"plain {worst:.3g}, cache {engine.cache_stats()}")

    for dt, (sched, out, wall) in served.items():
        reqs = sched_reqs[dt]
        statuses = {}
        for r in sched.request_log:
            statuses[r.status] = statuses.get(r.status, 0) + 1
        check(statuses == {"ok": len(reqs)}, f"statuses {statuses}")
        worst, same_iters = 0.0, 0
        iters = {r.rid: r.iters for r in sched.request_log}
        for rid, (K, a, b) in enumerate(reqs):
            P = torch.as_tensor(out[rid], device=dev)
            Pp, it = plain_single(K, a, b)
            within(P, Pp, dt, f"scheduler {str(dt)[6:]} rid {rid}",
                   call=False)
            worst = max(worst, rel(P, Pp))
            if dt == torch.float32:
                check(abs(iters[rid] - it) <= 1,
                      f"rid {rid}: {iters[rid]} iterations vs plain {it}")
                same_iters += iters[rid] == it
        st = sched.stats()
        lat = np.array([r.latency for r in sched.request_log])
        phases = ", ".join(
            f"{ph} {sched.obs.registry.histogram(f'profile.phase.serve.{ph}').sum * 1e3:.1f} ms"
            for ph in ("evict", "admit", "chunk"))
        log("serve", f"UOTScheduler {str(dt)[6:]}: {len(reqs)} requests in "
            f"{wall * 1e3:.1f} ms = {len(reqs) / wall:.1f} req/s, latency "
            f"p50 {np.percentile(lat, 50) * 1e3:.1f} ms p99 "
            f"{np.percentile(lat, 99) * 1e3:.1f} ms, statuses {statuses}, "
            f"iters mean {st['iters_mean']:.1f}, steps {st['steps']}, "
            f"worst rel err vs plain {worst:.3g}; host phases {phases}"
            + (f", iteration counts equal {same_iters}/{len(reqs)}"
               if dt == torch.float32 else ""))

    # ---- 5. kernel times -----------------------------------------------------
    def time_ms(fn, sets, reps=20, warm=3):
        """Device time per call of ``fn(*args)``, the calls taking the
        argument sets in turn. A spin kernel of ~10 ms holds the card while
        the host queues the timed calls, so a kernel shorter than the
        host's cost per call is timed, not the host."""
        for i in range(warm):
            fn(*sets[i % len(sets)])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(reps):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def cold(make, nbytes):
        """Argument sets from ``make()``, as many as make the big operands
        (``nbytes`` per set) span three times the L2: a call finds its
        operands in device memory, as a solve's first touch does."""
        return [make() for _ in range(-(-3 * L2_BYTES // nbytes))]

    def timed_row(name, t, dt, sets, reps=20, plain_reps=5):
        ms = time_ms(t["fn"], sets, reps=reps)
        plain_ms = time_ms(t["plain"], sets, reps=plain_reps, warm=1)
        lib_ms = time_ms(t["library"], sets) if t["library"] else None
        tb, tf = t["bytes"] / HBM_BYTES_PER_S, t["flops"] / FP32_FLOPS
        bound, by = max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"
        gbps = t["bytes"] / (ms * 1e-3) / 1e9
        log("time", f"{name} {'x'.join(map(str, t['shape']))} "
            f"{str(dt)[6:]} ({t['variant']}, {len(sets)} input copies): "
            f"kernel {ms:.4f} ms ({gbps:.0f} GB/s of {t['bytes'] / 1e6:.1f} "
            f"MB, {t['flops'] / (ms * 1e-3) / 1e12:.2f} TFLOP/s of "
            f"{t['flops'] / 1e9:.3f} GFLOP modelled), bound {bound:.4f} ms "
            f"({by}), plain {plain_ms:.4f} ms (not a yardstick), library "
            + (f"{lib_ms:.4f} ms ({t['lib_name']})" if lib_ms is not None
               else "none (no single PyTorch call computes it)"))
        return {"name": name, "dtype": str(dt)[6:], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": lib_ms, "achieved_GBps": gbps,
                "modelled_bytes": t["bytes"], "variant": t["variant"],
                "shape": t["shape"]}

    B, M, N = 8, 2048, 2048
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        s = torch.empty((), dtype=dt).element_size()
        fcol = torch.ones((B, N), device=dev)
        a = torch.full((B, M), 1.0 / M, device=dev)
        live = torch.ones(B, dtype=torch.bool, device=dev)
        mn = B * M * N
        sets = cold(lambda: ((torch.rand((B, M, N), generator=gen, device=dev)
                              + 0.1).to(dt), torch.zeros((B, N), device=dev)),
                    mn * s)
        pc, pd = ub.plan_colsum(B, M, N, s), ub.plan_for(B, M, N, s)
        table = {
            "batched_colsum": dict(
                fn=lambda A, _: ub.batched_colsum(A),
                plain=lambda A, _: ub.batched_colsum_plain(A),
                library=lambda A, _: A.float().sum(1),
                lib_name="A.float().sum(1)",
                bytes=mn * s + B * N * 4, flops=mn,
                variant=f"{B * pc.ctas * -(-N // (pc.vec * ub.THREADS))} "
                        f"blocks"),
            "batched_fused_iteration": dict(
                fn=lambda A, _: ub.batched_fused_iteration(A, fcol, a,
                                                           fi=0.95),
                plain=lambda A, _: ub.batched_fused_iteration_plain(
                    A, fcol, a, fi=0.95),
                library=None,
                bytes=2 * mn * s + 2 * B * N * 4 + B * M * 4, flops=5 * mn,
                variant=f"{pd.variant}, {B * pd.ctas} blocks"),
            "batched_fused_iteration_frow": dict(
                fn=lambda A, k: ub.batched_fused_iteration_frow(
                    A, fcol, a, live, k, fi=0.95),
                plain=lambda A, k: ub.batched_fused_iteration_frow_plain(
                    A, fcol, a, live, k, fi=0.95),
                library=None,
                bytes=2 * mn * s + 2 * B * N * 4 + 2 * B * M * 4 + B,
                flops=5 * mn, variant=f"{pd.variant}, {B * pd.ctas} blocks"),
        }
        for name, t in table.items():
            rows.append(timed_row(name, dict(t, shape=[B, M, N]), dt, sets))
        del sets

    # ---- 6. a traced scheduler run -------------------------------------------
    from torch.profiler import ProfilerActivity, profile
    traced = sched_reqs[torch.float32][:16]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched, out, _ = serve(torch.float32, traced, waves=2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(len(out) == len(traced), "traced scheduler run lost requests")
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if getattr(ev, "device_type", None) is not None
                   and ev.device_type.name == "CUDA")
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s

    def dev_us(item):
        return getattr(item, "self_device_time_total",
                       getattr(item, "self_cuda_time_total", 0.0))

    top = sorted(prof.key_averages(), key=dev_us, reverse=True)[:6]
    log("trace", f"UOTScheduler fp32, 16 requests traced: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}%); top device ops: "
        + "; ".join(f"{k.key[:60]} {dev_us(k) / 1e3:.2f} ms x{k.count}"
                    for k in top if dev_us(k) > 0))
    check(busy > 0, "the profiler saw no device time")

    # ---- 7. kernels a, b, f, g against their plain versions -------------------
    lib = _build.load()
    f32, b16 = torch.float32, torch.bfloat16
    for M in (4096, 8192):
        for dt in (f32, b16):
            A = (torch.rand((M, M), generator=gen, device=dev) + 0.1).to(dt)
            fcol = torch.rand(M, generator=gen, device=dev) + 0.5
            a = torch.rand(M, generator=gen, device=dev) + 0.5
            cs = uf.colsum(A)
            e_a = within(cs, uf.colsum_plain(A), dt, f"colsum {M}x{M}")
            A1, A2 = A.clone(), A.clone()
            _, c1 = uf.fused_iteration(A1, fcol, a, fi=0.95)
            _, c2 = uf.fused_iteration_plain(A2, fcol, a, fi=0.95)
            e_b = max(within(A1, A2, dt, f"fused_iteration {M}x{M}"),
                      within(c1, c2, dt, f"fused_iteration colsum {M}x{M}"))
            A3 = A.clone()
            _, c3 = uf.fused_iteration(A3, fcol, a, fi=0.95)
            check(torch.equal(A3, A1) and torch.equal(c3, c1)
                  and torch.equal(uf.colsum(A), cs),
                  f"a/b repeat launch not bitwise at {M}x{M} {dt}")
            plan, cplan = ub.plan_for(1, M, M, A.element_size()), \
                ub.plan_colsum(1, M, M, A.element_size())
            log("kernels", f"a, b {M}x{M} {str(dt)[6:]}: b {plan.variant} "
                f"block_m={plan.block_m} rows/cta={plan.rows_per_cta} "
                f"ctas={plan.ctas}; a rows/cta={cplan.rows_per_cta} "
                f"ctas={cplan.ctas} | max abs err a {e_a:.3g} b {e_b:.3g} "
                f"| repeat=bitwise")
            if M == 4096 and dt == f32:
                errs.update(colsum=e_a, fused_iteration=e_b)
            del A, A1, A2, A3
    def ties_only(got, want, A, a, b, fi, tol, what):
        """Per-lane iteration counts must be equal, except at a tie: a lane
        may stop one iteration apart only where the plain drift at the
        earlier stop lies within DRIFT_ATOL of tol. Returns the mask of
        lanes whose counts are equal."""
        same = got == want
        for lane in torch.nonzero(~same).flatten().tolist():
            k = min(int(got[lane]), int(want[lane]))
            _, _, _, e = ur.resident_solve_plain(
                A[lane:lane + 1].clone(), a[lane:lane + 1],
                b[lane:lane + 1], fi=fi, num_iters=k)
            check(tol is not None and abs(int(got[lane]) - int(want[lane]))
                  == 1 and abs(float(e[0]) - tol) <= DRIFT_ATOL,
                  f"{what}: lane {lane} ran {int(got[lane])} iterations, "
                  f"plain {int(want[lane])}; drift at {k} {float(e[0]):.4g}")
        return same

    cfg_f = UOTConfig(reg=reg, reg_m=1.0, num_iters=100, tol=1e-4)
    for (B, M, N) in ((256, 128, 384), (8, 128, 384), (8, 100, 300)):
        check(lib.uot_resident_smem_bytes(M, N) == ur.resident_smem_bytes(M, N),
              f"shared-memory budget of {M}x{N}: the kernel and "
              f"resident_fits disagree")
        K, a, b = stacks(B, M, N, reg)
        for dt in (f32, b16):
            for tol in (None, 1e-4):
                kw = dict(fi=cfg_f.fi, num_iters=100 if tol else 50, tol=tol)
                A1, A2, A3 = (K.to(dt, copy=True) for _ in range(3))
                _, c1, i1, e1 = ur.resident_solve(A1, a, b, **kw)
                _, c2, i2, e2 = ur.resident_solve_plain(A2, a, b, **kw)
                what = f"resident_solve B={B} {M}x{N} {str(dt)[6:]} tol={tol}"
                # lanes that tie at tol ran one iteration apart: they are
                # checked by ties_only, the rest against the plain answer
                same = ties_only(i1, i2, K.to(dt), a, b, kw["fi"], tol, what)
                n_ties = int((~same).sum())
                # per entry: fp32 EACH_RTOL; bf16 one rounding apart (both
                # round the fp32 tile once) and the pointwise / mass bars
                r_f = each(A1[same], A2[same],
                           EACH_RTOL if dt == f32 else BF16_ULP, what)
                e_f = within(A1[same], A2[same], dt, what, call=False)
                r_c = each(c1[same], c2[same], EACH_RTOL, what + " colsum")
                # the final drift of lanes that ran as many iterations: a
                # difference of row factors near 1, so its error is
                # absolute, a few ulps of 1.0
                d1, d2 = e1[same], e2[same]
                fin = torch.isfinite(d2)
                check(torch.equal(torch.isfinite(d1), fin) and torch.allclose(
                    d1[fin], d2[fin], rtol=1e-3, atol=DRIFT_ATOL),
                    f"{what}: final drift differs from plain")
                _, c3, i3, e3 = ur.resident_solve(A3, a, b, **kw)
                check(torch.equal(A3, A1) and torch.equal(c3, c1)
                      and torch.equal(i3, i1) and torch.equal(e3, e1),
                      f"{what}: repeat launch not bitwise")
                log("kernels", f"{what}: max abs err {e_f:.3g}, per entry "
                    f"max rel err P {r_f:.3g} colsum {r_c:.3g}, iterations "
                    f"{int(i1.min())}-{int(i1.max())}, equal to plain in "
                    f"{B - n_ties}/{B} lanes (the rest ties at tol), "
                    f"repeat=bitwise")
                if (B, dt, tol) == (256, f32, 1e-4):
                    errs["resident_solve"] = e_f
        del K, a, b, A1, A2, A3
    # kernel g on a mixed pool: lanes 0-3 at the cap, 4-7 converged, 8-11
    # unhealthy (they enter as converged, as ops does it), 12-23 live,
    # 24-31 free
    L, M, N = 32, 128, 384
    for dt in (f32, b16):
        cfg_g = UOTConfig(reg=reg, reg_m=1.0, num_iters=60, tol=1e-4,
                          dtype=dt)
        st = ops.make_lane_state(L, M, N, cfg_g)
        K, a, b = stacks(24, M, N, reg)
        ops.lane_admit(st, list(range(24)), K, a, b)
        st.iters[0:4] = 60
        st.iters[12:24] = torch.arange(12, device=dev, dtype=torch.int32)
        st.converged[4:8] = True
        st.healthy[8:12] = False
        conv = st.converged | ~st.healthy
        pre = [st.P, st.colsum, st.frow, st.iters, conv]
        s1 = [t.clone() for t in pre]
        s2 = [t.clone() for t in pre]
        kw = dict(fi=cfg_g.fi, n_iters=8, num_iters=60, tol=1e-4)
        ur.resident_stepped(*s1, st.active, st.a, st.b, **kw)
        ur.resident_stepped_plain(*s2, st.active, st.a, st.b, **kw)
        # per entry, as for f; colsum and frow are fp32 in both dtypes
        r_g = [each(s1[0], s2[0], EACH_RTOL if dt == f32 else BF16_ULP,
                    "resident_stepped P"),
               each(s1[1], s2[1], EACH_RTOL, "resident_stepped colsum"),
               each(s1[2], s2[2], EACH_RTOL, "resident_stepped frow")]
        if dt == b16:
            within(s1[0], s2[0], dt, "resident_stepped P", call=False)
        e_g = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(s1[:3], s2[:3]))
        check(torch.equal(s1[3], s2[3]) and torch.equal(s1[4], s2[4]),
              "resident_stepped iters / converged differ from plain")
        closed = torch.cat([torch.arange(0, 12), torch.arange(24, 32)])
        check(all(torch.equal(t[closed], t0[closed]) for t, t0 in
                  zip(s1, pre)), "resident_stepped touched a closed lane")
        check(bool((s1[3][12:24] > st.iters[12:24]).all()),
              "a live lane did not advance")
        s3 = [t.clone() for t in pre]
        ur.resident_stepped(*s3, st.active, st.a, st.b, **kw)
        check(all(torch.equal(x, y) for x, y in zip(s3, s1)),
              "resident_stepped repeat launch not bitwise")
        log("kernels", f"resident_stepped 32x{M}x{N} {str(dt)[6:]}: max abs "
            f"err {e_g:.3g}, per entry max rel err P {r_g[0]:.3g} colsum "
            f"{r_g[1]:.3g} frow {r_g[2]:.3g}; iters/converged equal to "
            f"plain; 20 closed lanes "
            f"untouched; repeat=bitwise")
        if dt == f32:
            errs["resident_stepped"] = e_g
        del st, K, pre, s1, s2, s3
    torch.cuda.synchronize()

    # ---- 8. the second slice's path, counted ---------------------------------
    def host_problems_mn(n, mlo, mhi, nlo, nhi):
        ms = torch.randint(mlo, mhi + 1, (n,), generator=gen, device=dev)
        ns = torch.randint(nlo, nhi + 1, (n,), generator=gen, device=dev)
        out = []
        for M, N in zip(ms.tolist(), ns.tolist()):
            K, a, b = stacks(1, M, N, reg)
            out.append((K[0].cpu().numpy(), a[0].cpu().numpy(),
                        b[0].cpu().numpy()))
        return out

    K4, a4, b4 = (x[0] for x in stacks(1, 4096, 4096, reg))
    Ks, as_, bs = (x[0] for x in stacks(1, 128, 384, reg))
    K256, a256, b256 = stacks(256, 128, 384, reg)
    small = host_problems_mn(64, 64, 128, 128, 384)
    large = host_problems(16, 1500, 2048, reg)
    torch.cuda.synchronize()
    cfg16 = UOTConfig(reg=reg, reg_m=1.0, num_iters=20, dtype=b16)

    def serve_auto(reqs, impl, waves=4):
        sched = UOTScheduler(cfg_tol, lanes_per_pool=8, chunk_iters=4,
                             m_bucket=64, n_bucket=128, impl=impl)
        per = -(-len(reqs) // waves)
        out = {}
        t0 = time.perf_counter()
        for w in range(waves):
            for K, a, b in reqs[w * per:(w + 1) * per]:
                sched.submit(K, a, b)
            out.update(sched.step())
        out.update(sched.run())
        return sched, out, time.perf_counter() - t0

    mixed = [x for pair in zip(small[:16], large) for x in pair] + small[16:]
    for mod in (ub, uf, ur):
        mod.reset_counts()
    ops.reset_dispatch_stats()
    path = {}
    t0 = time.perf_counter()
    path["fused fp32"] = ops.solve_fused(K4, a4, b4, cfg_fixed)
    path["fused bf16"] = ops.solve_fused(K4, a4, b4, cfg16)
    path["fused auto 4096"] = ops.solve_fused(K4, a4, b4, cfg_fixed,
                                              impl="auto")
    path["fused auto 128x384"] = ops.solve_fused(Ks, as_, bs, cfg_tol,
                                                 impl="auto")
    path["batched resident"] = ops.solve_fused_batched(
        K256, a256, b256, cfg_tol, impl="resident")
    torch.cuda.synchronize()
    t_solves = time.perf_counter() - t0
    solve_dispatch = ops.dispatch_stats()
    sched2, out2, wall2 = serve_auto(mixed, "auto")
    torch.cuda.synchronize()
    launches2 = {**ub.LAUNCHES, **uf.LAUNCHES, **ur.LAUNCHES}
    plain2 = {**ub.PLAIN_CALLS, **uf.PLAIN_CALLS, **ur.PLAIN_CALLS}
    log("launches", f"second path {launches2}; plain versions {plain2}")
    check(set(launches2) | THIRD | FOURTH == set(KERNELS),
          "kernel counters incomplete")
    check(all(v > 0 for k, v in launches2.items()
              if k not in THIRD | FOURTH),
          f"a kernel of the second path never launched: {launches2}")
    check(not any(plain2.values()),
          f"a plain version ran on the card path: {plain2}")
    check(solve_dispatch == {"resident": 1, "streamed": 1},
          f"solve_fused impl='auto' routing {solve_dispatch}")
    counters = sched2.obs.registry.dump()["counters"]
    routed = {k: counters.get(f"serve.dispatch.{k}", 0)
              for k in ("resident", "streamed")}
    check(routed["resident"] > 0 and routed["streamed"] > 0,
          f"scheduler impl='auto' did not use both tiers: {routed}")

    def plain_solve(K, a, b, cfg):
        return sinkhorn_uot_fused(torch.as_tensor(K, device=dev),
                                  torch.as_tensor(a, device=dev),
                                  torch.as_tensor(b, device=dev), cfg)

    for name, (K, a, b, cfg, dt) in {
            "fused fp32": (K4, a4, b4, cfg_fixed, f32),
            "fused bf16": (K4, a4, b4, cfg16, b16),
            "fused auto 4096": (K4, a4, b4, cfg_fixed, f32),
            "fused auto 128x384": (Ks, as_, bs, cfg_tol, f32)}.items():
        P, cs = path[name]
        Pp, st = plain_solve(K, a, b, cfg)
        check(bool(torch.isfinite(P).all()) and P.shape == K.shape
              and P.dtype == dt, f"solve_fused {name}: output")
        within(P, Pp, dt, f"solve_fused {name}", call=False)
        # fixed iteration counts: fp32 per entry too
        r_each = (f", per entry {each(P, Pp, EACH_RTOL, name):.3g}"
                  if dt == f32 and cfg.tol is None else "")
        log("solve_fused", f"{name}: rel err vs plain {rel(P, Pp):.3g}"
            f"{r_each} (plain iters {st['iters']})")
    P, cs = path["batched resident"]
    Pp, st = sinkhorn_uot_fused_batched(K256, a256, b256, cfg_tol)
    within(P, Pp, f32, "solve_fused_batched resident", call=False)
    log("solve_fused_batched", f"impl='resident' B=256 128x384: rel err vs "
        f"plain {rel(P, Pp):.3g}, plain iters {int(st['iters'].min())}-"
        f"{int(st['iters'].max())}; the five solves took "
        f"{t_solves * 1e3:.1f} ms")

    statuses, worst, iters2, ties, worst_each = {}, 0.0, {}, 0, 0.0
    for r in sched2.request_log:
        statuses[r.status] = statuses.get(r.status, 0) + 1
        iters2[r.rid] = r.iters
    check(statuses == {"ok": len(mixed)}, f"statuses {statuses}")
    for rid, (K, a, b) in enumerate(mixed):
        P = torch.as_tensor(out2[rid], device=dev)
        Pp, st = plain_solve(K, a, b, cfg_tol)
        within(P, Pp, f32, f"scheduler auto rid {rid}", call=False)
        worst = max(worst, rel(P, Pp))
        if iters2[rid] == st["iters"]:
            worst_each = max(worst_each, each(
                P, Pp, EACH_RTOL, f"scheduler auto rid {rid}"))
        else:
            # allowed only at a tie: the plain drift at the earlier stop
            # lies within DRIFT_ATOL of tol
            k = min(iters2[rid], st["iters"])
            _, st_k = plain_solve(K, a, b, UOTConfig(reg=reg, reg_m=1.0,
                                                     num_iters=k))
            check(abs(iters2[rid] - st["iters"]) == 1
                  and abs(st_k["err"] - cfg_tol.tol) <= DRIFT_ATOL,
                  f"scheduler auto rid {rid} {K.shape}: {iters2[rid]} "
                  f"iterations vs plain {st['iters']}, drift at {k} "
                  f"{st_k['err']:.3g}")
            ties += 1
    log("serve", f"UOTScheduler impl='auto' fp32: {len(mixed)} requests "
        f"(64 of M 64-128 x N 128-384, 16 of 1500-2048 per side) in "
        f"{wall2 * 1e3:.1f} ms; dispatch {routed}; statuses {statuses}; "
        f"worst rel err vs plain {worst:.3g} (per entry, equal counts "
        f"{worst_each:.3g}); iteration counts equal "
        f"{len(mixed) - ties}/{len(mixed)} (the rest ties at tol)")

    # ---- 9. times of kernels a, b, f, g; resident against streamed serving ----
    Mf = 4096
    Bf, Mr, Nr, T, chunk = 256, 128, 384, 50, 4
    # operations of one resident iteration of one lane: a product and a sum
    # per entry in phase II and again in phase IV, and about four per row
    # and per column (the factor's division and power, the drift)
    res_ops = 4 * Mr * Nr + 4 * (Mr + Nr)
    for dt in (f32, b16):
        s = torch.empty((), dtype=dt).element_size()
        fcol = torch.ones(Mf, device=dev)
        a = torch.full((Mf,), 1.0 / Mf, device=dev)
        mn = Mf * Mf
        pa, pb = ub.plan_colsum(1, Mf, Mf, s), ub.plan_for(1, Mf, Mf, s)
        sets_ab = cold(lambda: ((torch.rand((Mf, Mf), generator=gen,
                                             device=dev) + 0.1).to(dt),),
                       mn * s)
        table = {
            "colsum": dict(
                fn=uf.colsum, plain=uf.colsum_plain,
                library=lambda A: A.float().sum(0), lib_name="A.float().sum(0)",
                bytes=mn * s + Mf * 4, flops=mn, shape=[Mf, Mf], sets=sets_ab,
                variant=f"{pa.ctas}x{-(-Mf // (pa.vec * ub.THREADS))} "
                        f"blocks"),
            "fused_iteration": dict(
                fn=lambda A: uf.fused_iteration(A, fcol, a, fi=0.95),
                plain=lambda A: uf.fused_iteration_plain(A, fcol, a, fi=0.95),
                library=None, bytes=2 * mn * s + 2 * Mf * 4 + Mf * 4,
                flops=5 * mn, shape=[Mf, Mf], sets=sets_ab,
                variant=f"{pb.variant}, {pb.ctas} blocks"),
        }
        K, ar, br = stacks(Bf, Mr, Nr, reg)
        emn = Bf * Mr * Nr
        cs0 = K.float().sum(1)
        sets_f = cold(lambda: (K.to(dt, copy=True),), emn * s)
        sets_g = cold(lambda: (
            K.to(dt, copy=True), cs0.clone(),
            torch.ones((Bf, Mr), device=dev),
            torch.zeros(Bf, dtype=torch.int32, device=dev),
            torch.zeros(Bf, dtype=torch.bool, device=dev)), emn * s)
        actg = torch.ones(Bf, dtype=torch.bool, device=dev)
        gkw = dict(fi=cfg_tol.fi, n_iters=chunk, num_iters=2 ** 30, tol=None)
        table["resident_solve"] = dict(
            fn=lambda A: ur.resident_solve(A, ar, br, fi=cfg_tol.fi,
                                           num_iters=T),
            plain=lambda A: ur.resident_solve_plain(A, ar, br, fi=cfg_tol.fi,
                                                    num_iters=T),
            library=None, bytes=2 * emn * s + Bf * (2 * Nr + Mr) * 4 + Bf * 8,
            flops=Bf * T * res_ops + emn, shape=[Bf, Mr, Nr], sets=sets_f,
            variant=f"{T} iterations")
        table["resident_stepped"] = dict(
            fn=lambda P, cs, fr, it, cv: ur.resident_stepped(
                P, cs, fr, it, cv, actg, ar, br, **gkw),
            plain=lambda P, cs, fr, it, cv: ur.resident_stepped_plain(
                P, cs, fr, it, cv, actg, ar, br, **gkw),
            library=None,
            bytes=2 * emn * s + Bf * (4 * Nr + 3 * Mr) * 4 + Bf * 6,
            flops=Bf * chunk * res_ops, shape=[Bf, Mr, Nr], sets=sets_g,
            variant=f"{chunk}-iteration chunks")
        for name, t in table.items():
            rows.append(timed_row(
                name, t, dt, t["sets"],
                reps=10 if name.startswith("res") else 20, plain_reps=3))
        if dt == f32:
            for Bo in (8, 132):
                Ao, ao, bo = K[:Bo].clone(), ar[:Bo], br[:Bo]
                ms = time_ms(lambda A: ur.resident_solve(
                    A, ao, bo, fi=cfg_tol.fi, num_iters=T), [(Ao,)], reps=10)
                log("time", f"resident_solve B={Bo} 128x384 fp32 ({T} "
                    f"iterations): {ms:.4f} ms = {ms * 1e3 / T:.2f} us per "
                    f"iteration; {Bo} of {ub.NUM_SMS} SMs busy")
        del K, sets_ab, sets_f, sets_g
    lat = {}
    for impl in (None, "auto", "auto", None):
        sched, out, wall = serve_auto(small, impl)
        check(len(out) == len(small), "small-request run lost requests")
        l_ms = np.array([r.latency for r in sched.request_log]) * 1e3
        key = "resident (auto)" if impl else "streamed"
        lat.setdefault(key, []).append(
            (float(np.percentile(l_ms, 50)), float(np.percentile(l_ms, 99)),
             wall * 1e3))
    log("serve", "64 small requests (M 64-128, N 128-384), fp32, tol 1e-4, "
        "order streamed, auto, auto, streamed: " + "; ".join(
            f"{k}: p50 " + "/".join(f"{x[0]:.1f}" for x in v) + " ms, p99 "
            + "/".join(f"{x[1]:.1f}" for x in v) + " ms, wall "
            + "/".join(f"{x[2]:.1f}" for x in v) + " ms"
            for k, v in lat.items()))

    # ---- 10. kernels h, i, j, k against their plain versions ------------------
    from repro_torch.geometry import PointCloudGeometry
    from repro_torch.geometry.pointcloud import sq_norms
    from repro_torch.kernels import uot_geometry as ug

    def coords(B, M, N, d, ragged=True):
        """Point-cloud operands on the card: coordinates in the unit cube,
        squared norms, valid counts (ragged after the first problem)."""
        x = torch.rand((B, M, d), generator=gen, device=dev)
        y = torch.rand((B, N, d), generator=gen, device=dev)
        mv = torch.full((B,), M, dtype=torch.int32, device=dev)
        nv = torch.full((B,), N, dtype=torch.int32, device=dev)
        if ragged and B > 1:
            mv[1:] = torch.randint(M // 2, M + 1, (B - 1,), generator=gen,
                                   device=dev, dtype=torch.int32)
            nv[1:] = torch.randint(N // 2, N + 1, (B - 1,), generator=gen,
                                   device=dev, dtype=torch.int32)
        return (x, sq_norms(x), y, sq_norms(y), mv, nv)

    def marginals(ops_):
        """Row and column marginals, zero past the valid counts."""
        x, _, y, _, mv, nv = ops_
        B, M, N = x.shape[0], x.shape[1], y.shape[1]
        rows = torch.arange(M, device=dev)[None] < mv[:, None]
        cols = torch.arange(N, device=dev)[None] < nv[:, None]
        a = (torch.rand((B, M), generator=gen, device=dev) + 0.5) * rows
        b = (torch.rand((B, N), generator=gen, device=dev) + 0.5) * cols
        return a / a.sum(1, keepdim=True), b / b.sum(1, keepdim=True) * 1.2

    def ulps(got, want):
        """Largest distance in units in the last place between two tensors
        of non-negative values of one floating type."""
        it = torch.int32 if got.dtype == torch.float32 else torch.int16
        return int((got.view(it).long() - want.view(it).long()).abs().max())

    def masked_zero(P, mv, nv, what):
        for k, (m, n) in enumerate(zip(mv.tolist(), nv.tolist())):
            check(bool((P[k, m:] == 0).all() and (P[k, :, n:] == 0).all()),
                  f"{what}: problem {k} not exactly zero past its valid "
                  f"counts ({m}, {n})")

    gkw = dict(reg=reg, scale=1.0)
    fi_g = cfg_tol.fi
    for (B, M, N, d) in ((8, 2048, 2048, 3), (3, 1000, 1500, 2),
                         (4, 128, 384, 9)):
        ops_ = coords(B, M, N, d)
        a, _ = marginals(ops_)
        fcol = torch.rand((B, N), generator=gen, device=dev) + 0.5
        for dt in (f32, b16):
            name = f"{B}x{M}x{N} d={d} {str(dt)[6:]}"
            K = ug.batched_pc_materialize(*ops_, out_dtype=dt, **gkw)
            Kp = ug.batched_pc_materialize_plain(*ops_, out_dtype=dt, **gkw)
            u_j = ulps(K, Kp)
            check(u_j <= (2 if dt == f32 else 1),
                  f"batched_pc_materialize {name}: {u_j} ulps from plain")
            same_j = float((K == Kp).float().mean())
            masked_zero(K, ops_[4], ops_[5], f"batched_pc_materialize {name}")
            e_j = float((K.float() - Kp.float()).abs().max())
            cs = ug.batched_pc_colsum(*ops_, storage_dtype=dt, **gkw)
            e_h = within(cs, ug.batched_pc_colsum_plain(
                *ops_, storage_dtype=dt, **gkw), f32, f"pc colsum {name}")
            A1, c1, f1 = ug.batched_pc_first_iteration(
                fcol, a, *ops_, fi=fi_g, out_dtype=dt, **gkw)
            A2, c2, f2 = ug.batched_pc_first_iteration_plain(
                fcol, a, *ops_, fi=fi_g, out_dtype=dt, **gkw)
            e_i = max(within(A1, A2, dt, f"pc first iteration {name}"),
                      within(c1, c2, f32, f"pc first iteration colsum {name}"),
                      within(f1, f2, f32, f"pc first iteration frow {name}"))
            masked_zero(A1, ops_[4], ops_[5], f"pc first iteration {name}")
            A3, c3, f3 = ug.batched_pc_first_iteration(
                fcol, a, *ops_, fi=fi_g, out_dtype=dt, **gkw)
            check(torch.equal(ug.batched_pc_materialize(
                *ops_, out_dtype=dt, **gkw), K) and torch.equal(
                ug.batched_pc_colsum(*ops_, storage_dtype=dt, **gkw), cs)
                and torch.equal(A3, A1) and torch.equal(c3, c1)
                and torch.equal(f3, f1), f"h/i/j repeat not bitwise {name}")
            # the dense twins over j's output: h is c, i is d, bit for bit
            Kd = K.clone()
            _, cd = ub.batched_fused_iteration(Kd, fcol, a, fi=fi_g)
            check(torch.equal(ub.batched_colsum(K), cs),
                  f"h differs from c over j's output at {name}")
            check(torch.equal(Kd, A1) and torch.equal(cd, c1),
                  f"i differs from d over j's output at {name}")
            log("kernels", f"h, i, j {name}: j within {u_j} ulps of plain "
                f"({100 * same_j:.2f}% of entries bitwise), max abs err "
                f"h {e_h:.3g} i {e_i:.3g} j {e_j:.3g}; masked regions exact;"
                f" h = c(j) and i = d(j) bitwise; repeat=bitwise")
            if (B, M, N, d) == (8, 2048, 2048, 3) and dt == f32:
                errs.update(batched_pc_colsum=e_h,
                            batched_pc_first_iteration=e_i,
                            batched_pc_materialize=e_j)
            del K, Kp, A1, A2, A3, Kd
    for (B, M, N, d) in ((256, 128, 384, 2), (8, 100, 300, 3)):
        ops_ = coords(B, M, N, d)
        a, b = marginals(ops_)
        for dt in (f32, b16):
            for tol in (None, 1e-4):
                kw = dict(fi=fi_g, num_iters=100 if tol else 50, tol=tol)
                what = f"resident_solve_pc B={B} {M}x{N} d={d} " \
                       f"{str(dt)[6:]} tol={tol}"
                P, cs, it, err = ur.resident_solve_pc(
                    *ops_[:4], a, b, *ops_[4:], out_dtype=dt, **gkw, **kw)
                Pp, csp, itp, errp = ur.resident_solve_pc_plain(
                    *ops_[:4], a, b, *ops_[4:], out_dtype=dt, **gkw, **kw)
                Kp = ug.batched_pc_materialize_plain(*ops_, out_dtype=dt,
                                                     **gkw)
                same = ties_only(it, itp, Kp, a, b, fi_g, tol, what)
                r_k = each(P[same], Pp[same],
                           EACH_RTOL if dt == f32 else BF16_ULP, what)
                e_k = within(P[same], Pp[same], dt, what, call=False)
                each(cs[same], csp[same], EACH_RTOL, what + " colsum")
                masked_zero(P, ops_[4], ops_[5], what)
                K = ug.batched_pc_materialize(*ops_, out_dtype=dt, **gkw)
                f_out = ur.resident_solve(K, a, b, **kw)
                k_again = ur.resident_solve_pc(*ops_[:4], a, b, *ops_[4:],
                                               out_dtype=dt, **gkw, **kw)
                for other, label in ((f_out, "f over j's output"),
                                     (k_again, "a repeat launch")):
                    check(all(torch.equal(u, v) for u, v in
                              zip(other, (P, cs, it, err))),
                          f"{what}: differs from {label}")
                log("kernels", f"{what}: max abs err {e_k:.3g}, per entry "
                    f"max rel err {r_k:.3g}, iterations {int(it.min())}-"
                    f"{int(it.max())}, equal to plain in "
                    f"{int(same.sum())}/{B} lanes (the rest ties at tol); "
                    f"k = f(j) bitwise; repeat=bitwise")
                if (B, dt, tol) == (256, f32, 1e-4):
                    errs["resident_solve_pc"] = e_k
                del P, Pp, Kp, K, f_out, k_again

    def point_problems(n, mlo, mhi, nlo, nhi, d):
        """n point requests as host numpy: (x, y, a, b)."""
        ms = torch.randint(mlo, mhi + 1, (n,), generator=gen, device=dev)
        ns = torch.randint(nlo, nhi + 1, (n,), generator=gen, device=dev)
        out = []
        for M, N in zip(ms.tolist(), ns.tolist()):
            ops_ = coords(1, M, N, d)
            a, b = marginals(ops_)
            out.append((ops_[0][0].cpu().numpy(), ops_[2][0].cpu().numpy(),
                        a[0].cpu().numpy(), b[0].cpu().numpy()))
        return out

    def gibbs_host(x, y):
        """``PointCloudGeometry.kernel`` of one request, as host numpy."""
        return PointCloudGeometry.from_points(x, y).kernel(reg).cpu().numpy()

    # the point paths of the engine and the scheduler against dense
    # submission of the geometry's kernel, on the card: bit for bit
    pair_reqs = (point_problems(8, 64, 128, 128, 384, 2)
                 + point_problems(4, 300, 500, 300, 500, 2))
    for dt in (f32, b16):
        cfg_p = UOTConfig(reg=reg, reg_m=1.0, num_iters=60, tol=1e-4,
                          dtype=dt)
        for impl in (None, "auto"):
            ep = UOTBatchEngine(cfg_p, m_bucket=64, n_bucket=128, impl=impl)
            ed = UOTBatchEngine(cfg_p, m_bucket=64, n_bucket=128, impl=impl)
            pairs = [(ep.submit_points(x, y, a, b),
                      ed.submit(gibbs_host(x, y), a, b))
                     for x, y, a, b in pair_reqs]
            rp, rd = ep.flush(), ed.flush()
            check(all(np.array_equal(rp[p], rd[q]) for p, q in pairs),
                  f"engine points differ from dense ({dt}, impl={impl})")
        sp = UOTScheduler(cfg_p, lanes_per_pool=4, chunk_iters=4,
                          m_bucket=64, n_bucket=128)
        sd = UOTScheduler(cfg_p, lanes_per_pool=4, chunk_iters=4,
                          m_bucket=64, n_bucket=128)
        pairs = [(sp.submit_points(x, y, a, b),
                  sd.submit(gibbs_host(x, y), a, b))
                 for x, y, a, b in pair_reqs]
        op_, od = sp.run(), sd.run()
        itp = {r.rid: r.iters for r in sp.request_log}
        itd = {r.rid: r.iters for r in sd.request_log}
        check(all(np.array_equal(op_[p], od[q]) and itp[p] == itd[q]
                  for p, q in pairs),
              f"scheduler points differ from dense ({dt})")
        log("serve", f"{len(pair_reqs)} point requests (64-500 per side, "
            f"d=2) {str(dt)[6:]}: engine (impl None and 'auto') and "
            f"scheduler point paths equal dense submission of kernel() bit "
            f"for bit, scheduler iteration counts equal")
    torch.cuda.synchronize()

    # ---- 11. the third slice's path, counted ----------------------------------
    def batched_geometry(B, M, N, d):
        ops_ = coords(B, M, N, d, ragged=False)
        a, b = marginals(ops_)
        return PointCloudGeometry(x=ops_[0], y=ops_[2], xn=ops_[1],
                                  yn=ops_[3]), a, b

    geo8, a8, b8 = batched_geometry(8, 2048, 2048, 3)
    geo4k, a4k, b4k = batched_geometry(1, 4096, 4096, 3)
    geo256, a256g, b256g = batched_geometry(256, 128, 384, 2)
    eng_reqs = (point_problems(16, 64, 128, 128, 384, 2)
                + point_problems(16, 1500, 2048, 1500, 2048, 3))
    eng_reqs = [r for pair in zip(eng_reqs[:16], eng_reqs[16:])
                for r in pair]
    sched_pts = {dt: point_problems(64, 1500, 2048, 1500, 2048, 3)
                 for dt in (f32, b16)}
    small_pts = point_problems(64, 64, 128, 128, 384, 2)
    large_pts = point_problems(16, 1500, 2048, 1500, 2048, 3)
    dense_small = host_problems_mn(16, 64, 128, 128, 384)
    cfg_tol16 = UOTConfig(reg=reg, reg_m=1.0, num_iters=100, tol=1e-4,
                          dtype=b16)
    torch.cuda.synchronize()

    def serve_points(cfg, reqs, *, waves=8, impl=None, m_bucket=512,
                     n_bucket=512, dense=()):
        """Point requests (and dense ones, interleaved) in waves between
        scheduler rounds; returns (scheduler, results, rids, wall s)."""
        sched = UOTScheduler(cfg, lanes_per_pool=8, chunk_iters=4,
                             m_bucket=m_bucket, n_bucket=n_bucket, impl=impl)
        items = [("points", r) for r in reqs]
        for i, r in enumerate(dense):
            items.insert(2 * i + 1, ("dense", r))
        per = -(-len(items) // waves)
        out, rids = {}, []
        t0 = time.perf_counter()
        for w in range(waves):
            for kind, r in items[w * per:(w + 1) * per]:
                rids.append((kind, r, sched.submit_points(*r)
                             if kind == "points" else sched.submit(*r)))
            out.update(sched.step())
        out.update(sched.run())
        return sched, out, rids, time.perf_counter() - t0

    for mod in (ub, uf, ur, ug):
        mod.reset_counts()
    ops.reset_dispatch_stats()
    path3 = {}
    t0 = time.perf_counter()
    path3["batched fp32"] = ops.solve_fused_batched(None, a8, b8, cfg_fixed,
                                                    geometry=geo8)
    path3["batched fp32 tol"] = ops.solve_fused_batched(
        None, a8, b8, cfg_tol, geometry=geo8)
    path3["batched bf16 tol"] = ops.solve_fused_batched(
        None, a8, b8, cfg_tol16, geometry=geo8)
    path3["fused 4096"] = ops.solve_fused(None, a4k[0], b4k[0], cfg_fixed,
                                          geometry=geo4k)
    path3["resident"] = ops.solve_fused_resident(None, a256g, b256g, cfg_tol,
                                                 geometry=geo256)
    path3["batched auto"] = ops.solve_fused_batched(
        None, a256g, b256g, cfg_tol, geometry=geo256, impl="auto")
    torch.cuda.synchronize()
    t_solves3 = time.perf_counter() - t0
    dispatch3 = ops.dispatch_stats()
    engine3 = UOTBatchEngine(cfg_tol, m_bucket=64, n_bucket=128, impl="auto")
    erids = [engine3.submit_points(*r) for r in eng_reqs]
    t0 = time.perf_counter()
    flushed3 = engine3.flush()
    t_flush3 = time.perf_counter() - t0
    served3 = {dt: serve_points(UOTConfig(reg=reg, reg_m=1.0, num_iters=100,
                                          tol=1e-4, dtype=dt), reqs)
               for dt, reqs in sched_pts.items()}
    mixed3 = [r for pair in zip(small_pts[:16], large_pts) for r in pair] \
        + small_pts[16:]
    auto3 = serve_points(cfg_tol, mixed3, waves=4, impl="auto", m_bucket=64,
                         n_bucket=128, dense=dense_small)
    torch.cuda.synchronize()
    launches3 = {**ub.LAUNCHES, **uf.LAUNCHES, **ur.LAUNCHES, **ug.LAUNCHES}
    plain3 = {**ub.PLAIN_CALLS, **uf.PLAIN_CALLS, **ur.PLAIN_CALLS,
              **ug.PLAIN_CALLS}
    log("launches", f"third path {launches3}; plain versions {plain3}")
    check(set(launches3) | FOURTH == set(KERNELS),
          "kernel counters incomplete")
    check(all(launches3[k] > 0 for k in THIRD),
          f"a kernel of the third path never launched: {launches3}")
    check(not any(plain3.values()),
          f"a plain version ran on the card path: {plain3}")
    check(dispatch3 == {"resident": 1, "streamed": 0},
          f"solve_fused_batched(geometry=, impl='auto') routing {dispatch3}")
    counters3 = auto3[0].obs.registry.dump()["counters"]
    routed3 = {k: counters3.get(f"serve.dispatch.{k}", 0)
               for k in ("resident", "streamed")}
    check(routed3["resident"] > 0 and routed3["streamed"] > 0,
          f"point scheduler impl='auto' did not use both tiers: {routed3}")

    # ---- results of the third path against plain solves on the card ----------
    def plain_kernel(g):
        """The geometry's kernel by the plain version (fp32)."""
        o = g.operands(dev)
        return ug.batched_pc_materialize_plain(*o, reg=reg,
                                               scale=g.scale)

    for name, cfg in (("batched fp32", cfg_fixed),
                      ("batched fp32 tol", cfg_tol),
                      ("batched bf16 tol", cfg_tol16)):
        P, cs = path3[name]
        Pp, st = sinkhorn_uot_fused_batched(plain_kernel(geo8), a8, b8,
                                            UOTConfig(reg=reg, reg_m=1.0,
                                                      num_iters=cfg.num_iters,
                                                      tol=cfg.tol))
        check(bool(torch.isfinite(P).all()) and P.shape == (8, 2048, 2048)
              and P.dtype == cfg.dtype, f"geometry {name}: output")
        within(P, Pp, cfg.dtype, f"solve_fused_batched(geometry=) {name}",
               call=False)
        log("solve_fused_batched", f"geometry= B=8 2048x2048 d=3 {name}: "
            f"rel err vs plain {rel(P, Pp):.3g}, plain iters "
            f"{st['iters'].tolist()}")
        del Pp
    P, cs = path3["fused 4096"]
    Pp, st = sinkhorn_uot_fused(plain_kernel(geo4k)[0], a4k[0], b4k[0],
                                cfg_fixed)
    within(P, Pp, f32, "solve_fused(geometry=) 4096x4096", call=False)
    log("solve_fused", f"geometry= 4096x4096 d=3 fp32: rel err vs plain "
        f"{rel(P, Pp):.3g}, per entry {each(P, Pp, EACH_RTOL, 'fused 4096'):.3g}")
    del Pp
    P, cs, it, err = path3["resident"]
    Kp = plain_kernel(geo256)
    _, _, itp, _ = ur.resident_solve_plain(Kp.clone(), a256g, b256g,
                                           fi=cfg_tol.fi, num_iters=100,
                                           tol=1e-4)
    same = ties_only(it, itp, Kp, a256g, b256g, cfg_tol.fi, 1e-4,
                     "solve_fused_resident(geometry=)")
    Pp, st = sinkhorn_uot_fused_batched(Kp, a256g, b256g, cfg_tol)
    within(P, Pp, f32, "solve_fused_resident(geometry=)", call=False)
    check(torch.equal(path3["batched auto"][0], P),
          "impl='auto' geometry solve differs from solve_fused_resident")
    log("solve_fused_resident", f"geometry= B=256 128x384 d=2: rel err vs "
        f"plain {rel(P, Pp):.3g}, iterations equal in {int(same.sum())}/"
        f"{len(same)} lanes (the rest ties at tol); the six solves took "
        f"{t_solves3 * 1e3:.1f} ms")

    def held(out, rid, x, y, a, b, dt, iters, what):
        """One served point request against a plain solve on the card;
        returns (rel err, whether the iteration counts are equal). Its
        kernel is j's plain version on the card: no kernel of this slice
        makes the reference."""
        K = plain_kernel(PointCloudGeometry.from_points(x, y))[0]
        Pp, st = plain_solve(K, a, b, cfg_tol)
        P = torch.as_tensor(out[rid], device=dev)
        within(P, Pp, dt, what, call=False)
        if iters is not None and iters != st["iters"]:
            k = min(iters, st["iters"])
            _, st_k = plain_solve(K, a, b, UOTConfig(reg=reg, reg_m=1.0,
                                                     num_iters=k))
            check(abs(iters - st["iters"]) == 1
                  and abs(st_k["err"] - cfg_tol.tol) <= DRIFT_ATOL,
                  f"{what}: {iters} iterations vs plain {st['iters']}")
        return rel(P, Pp), iters is None or iters == st["iters"]

    check(sorted(flushed3) == erids, "point flush lost requests")
    worst = max(held(flushed3, rid, *r, f32, None, f"engine points rid {rid}")[0]
                for rid, r in zip(erids, eng_reqs))
    log("engine", f"UOTBatchEngine(impl='auto') flush of {len(erids)} point "
        f"requests (16 of M 64-128 x N 128-384 d=2, 16 of 1500-2048 d=3) in "
        f"{t_flush3 * 1e3:.1f} ms, worst rel err vs plain {worst:.3g}, "
        f"dispatch {engine3.last_dispatch}")
    for label, (sched, out, rids, wall) in (
            [(f"{str(dt)[6:]}", v) for dt, v in served3.items()]
            + [("auto mixed", auto3)]):
        dt = sched.cfg.dtype
        statuses = {}
        for r in sched.request_log:
            statuses[r.status] = statuses.get(r.status, 0) + 1
        check(statuses == {"ok": len(rids)}, f"statuses {statuses}")
        iters = {r.rid: r.iters for r in sched.request_log}
        worst, equal = 0.0, 0
        for kind, r, rid in rids:
            if kind == "dense":
                K, a, b = r
                Pp, st = plain_solve(K, a, b, cfg_tol)
                within(torch.as_tensor(out[rid], device=dev), Pp, dt,
                       f"scheduler {label} dense rid {rid}", call=False)
                equal += iters[rid] == st["iters"]
                continue
            e, same_it = held(out, rid, *r, dt,
                              iters[rid] if dt == f32 else None,
                              f"scheduler {label} rid {rid}")
            worst = max(worst, e)
            equal += same_it
        lat = np.array([r.latency for r in sched.request_log])
        phases = ", ".join(
            f"{ph} {sched.obs.registry.histogram(f'profile.phase.serve.{ph}').sum * 1e3:.1f} ms"
            for ph in ("evict", "admit", "chunk"))
        log("serve", f"UOTScheduler {label} point requests: {len(rids)} in "
            f"{wall * 1e3:.1f} ms = {len(rids) / wall:.1f} req/s, latency "
            f"p50 {np.percentile(lat, 50) * 1e3:.1f} ms p99 "
            f"{np.percentile(lat, 99) * 1e3:.1f} ms, statuses {statuses}, "
            f"host phases {phases}, worst rel err vs plain {worst:.3g}"
            + (f", iteration counts equal {equal}/{len(rids)} (the rest "
               f"ties at tol)" if dt == f32 else "")
            + (f", dispatch {routed3}" if label == "auto mixed" else ""))

    # ---- 12. times of kernels h, i, j, k; what the geometry saves end to end --
    def per_entry_ops(d):
        # the tile: 2d - 1 for the dot, 4 for the norms' sum, the doubling,
        # the difference and the division by reg, about 7 for expf
        return 2 * d + 10

    B, M, N, d = 8, 2048, 2048, 3
    mn = B * M * N
    coord_bytes = B * (M + N) * (d + 1) * 4 + 8 * B
    fcol8 = torch.ones((B, N), device=dev)
    aa8 = torch.full((B, M), 1.0 / M, device=dev)
    sets_pc = cold(lambda: coords(B, M, N, d, ragged=False), coord_bytes)
    for dt in (f32, b16):
        s = torch.empty((), dtype=dt).element_size()
        pc, pd = ub.plan_colsum(B, M, N, s), ub.plan_for(B, M, N, s)
        table = {
            "batched_pc_colsum": dict(
                fn=lambda *o: ug.batched_pc_colsum(*o, storage_dtype=dt,
                                                   **gkw),
                plain=lambda *o: ug.batched_pc_colsum_plain(
                    *o, storage_dtype=dt, **gkw),
                library=None, bytes=coord_bytes + B * N * 4,
                flops=mn * (per_entry_ops(d) + 1),
                variant=f"d={d}, c's plan, {B * pc.ctas} row blocks"),
            "batched_pc_first_iteration": dict(
                fn=lambda *o: ug.batched_pc_first_iteration(
                    fcol8, aa8, *o, fi=0.95, out_dtype=dt, **gkw),
                plain=lambda *o: ug.batched_pc_first_iteration_plain(
                    fcol8, aa8, *o, fi=0.95, out_dtype=dt, **gkw),
                library=None,
                bytes=mn * s + coord_bytes + 2 * B * N * 4 + 2 * B * M * 4,
                flops=mn * (per_entry_ops(d) + 5),
                variant=f"d={d}, d's plan, {pd.variant}, {B * pd.ctas} "
                        f"blocks"),
            "batched_pc_materialize": dict(
                fn=lambda *o: ug.batched_pc_materialize(*o, out_dtype=dt,
                                                        **gkw),
                plain=lambda *o: ug.batched_pc_materialize_plain(
                    *o, out_dtype=dt, **gkw),
                library=None, bytes=mn * s + coord_bytes,
                flops=mn * per_entry_ops(d), variant=f"d={d}"),
        }
        for name, t in table.items():
            rows.append(timed_row(name, dict(t, shape=[B, M, N]), dt,
                                  sets_pc))
    del sets_pc
    Bk, Mk, Nk, dk, Tk = 256, 128, 384, 2, 50
    kmn = Bk * Mk * Nk
    kcoord = Bk * (Mk + Nk) * (dk + 1) * 4 + 8 * Bk
    ak = torch.full((Bk, Mk), 1.0 / Mk, device=dev)
    bk = torch.full((Bk, Nk), 1.2 / Nk, device=dev)
    sets_k = cold(lambda: coords(Bk, Mk, Nk, dk, ragged=False), kcoord)
    for dt in (f32, b16):
        s = torch.empty((), dtype=dt).element_size()
        t = dict(
            fn=lambda x, xn, y, yn, mv, nv: ur.resident_solve_pc(
                x, xn, y, yn, ak, bk, mv, nv, fi=cfg_tol.fi, num_iters=Tk,
                out_dtype=dt, **gkw),
            plain=lambda x, xn, y, yn, mv, nv: ur.resident_solve_pc_plain(
                x, xn, y, yn, ak, bk, mv, nv, fi=cfg_tol.fi, num_iters=Tk,
                out_dtype=dt, **gkw),
            library=None,
            bytes=kmn * s + kcoord + Bk * (Mk + 2 * Nk) * 4 + Bk * 8,
            flops=(Bk * Tk * res_ops + kmn * per_entry_ops(dk) + kmn),
            shape=[Bk, Mk, Nk], variant=f"d={dk}, {Tk} iterations")
        rows.append(timed_row("resident_solve_pc", t, dt, sets_k, reps=10,
                              plain_reps=3))
    del sets_k

    # end to end, from host numpy: coordinates and geometry= against the
    # host-materialized kernel shipped dense (a line, not a claim)
    ops_h = coords(B, M, N, d, ragged=False)
    xh, yh = ops_h[0].cpu().numpy(), ops_h[2].cpu().numpy()
    ah, bh = (t.cpu().numpy() for t in marginals(ops_h))
    Kh = PointCloudGeometry.from_points(xh, yh).kernel(reg).cpu().numpy()

    def e2e(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "geometry":
            g = PointCloudGeometry.from_points(xh, yh)
            P, _ = ops.solve_fused_batched(None, ah, bh, cfg_fixed,
                                           geometry=g)
        else:
            P, _ = ops.solve_fused_batched(Kh, ah, bh, cfg_fixed)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    e2e("geometry"), e2e("dense")                    # warm up
    order = ("geometry", "dense", "dense", "geometry")
    e2e_ms = [(k, e2e(k)) for k in order]
    log("e2e", f"solve_fused_batched B=8 2048x2048 d=3 fp32, "
        f"{cfg_fixed.num_iters} iterations, from host numpy (host clock, "
        f"order {', '.join(order)}): "
        + "; ".join(f"{k} {ms:.2f} ms" for k, ms in e2e_ms)
        + f" — the request ships {xh.nbytes + yh.nbytes} bytes of "
        f"coordinates with geometry=, {Kh.nbytes} bytes of kernel dense")
    del Kh

    # ---- 14. kernels l, m, n, o against their plain versions -----------------
    from repro_torch.core.health import uv_safe
    from repro_torch.core.problem import rescale_factors
    from repro_torch.core.sinkhorn_uv import sinkhorn_uot_uv_fused
    from repro_torch.kernels import uot_uv_fused as uuv

    def uv_inputs(B, M, N):
        """K (B, M, N) of Gibbs entries and a as for the solves, and a
        random v (not all ones, so a K^T u that took the v-scaled tile
        would show)."""
        K, a, _ = stacks(B, M, N, reg)
        v = torch.rand((B, N), generator=gen, device=dev) + 0.5
        return K, a, v

    def uv_kernels(B):
        """(names, kernel l or n, its plain version, kernel m or o, its
        plain version): the single-problem kernels at B = 1."""
        mod = uuv if B == 1 else ub
        names = (("uv_iteration", "materialize_coupling") if B == 1 else
                 ("batched_uv_iteration", "batched_materialize_coupling"))
        return (names, *(getattr(mod, n + x) for n in names
                         for x in ("", "_plain")))

    for (B, M, N) in ((1, 4096, 4096), (8, 2048, 2048), (3, 1500, 2047)):
        K32, a, v = uv_inputs(B, M, N)
        names, it_fn, it_plain, mat_fn, mat_plain = uv_kernels(B)
        if B == 1:
            K32, a, v = K32[0], a[0], v[0]
        for dt in (f32, b16):
            K = K32.to(dt)
            for fi in ((0.95, 1.0) if B == 3 else (0.95,)):
                what = f"{B}x{M}x{N} {str(dt)[6:]} fi={fi}"
                u, ktu = it_fn(K, v, a, fi=fi)
                u_p, ktu_p = it_plain(K, v, a, fi=fi)
                r_u = each(u, u_p, F32_RTOL, f"{names[0]} u {what}")
                r_k = each(ktu, ktu_p, F32_RTOL, f"{names[0]} ktu {what}")
                P = mat_fn(K, u, v)
                check(all(torch.equal(mat_fn(K, u, v, out_dtype=o),
                                      mat_plain(K, u, v, out_dtype=o))
                          for o in (f32, b16)) and P.dtype == f32,
                      f"{names[1]} {what}: not bit for bit its plain "
                      f"version")
                u2, ktu2 = it_fn(K, v, a, fi=fi)
                check(torch.equal(u2, u) and torch.equal(ktu2, ktu)
                      and torch.equal(mat_fn(K, u, v), P),
                      f"{names[0]}/{names[1]} {what}: repeat launch not "
                      f"bitwise")
                e_l = max(float((u - u_p).abs().max()),
                          float((ktu - ktu_p).abs().max()))
                plan = ub.plan_for(B, M, N, K.element_size())
                log("kernels", f"{names[0]}, {names[1]} {what}: "
                    f"{plan.variant} block_m={plan.block_m} rows/cta="
                    f"{plan.rows_per_cta} ctas={plan.ctas} vec={plan.vec} | "
                    f"max abs err {e_l:.3g}, per entry max rel err u "
                    f"{r_u:.3g} ktu {r_k:.3g} | {names[1]} fp32 and bf16 "
                    f"out bit for bit | repeat=bitwise")
                if dt == f32 and fi == 0.95 and B in (1, 8):
                    errs[names[0]] = e_l
                    errs[names[1]] = float(
                        (P - mat_plain(K, u, v)).abs().max())
            del K
        del K32, a, v
    torch.cuda.synchronize()

    # ---- 15. the fourth slice's path, counted ---------------------------------
    def uv_problem(B, M, N):
        K, a, b = stacks(B, M, N, reg)
        for k in range(B):
            check(uv_safe(cfg_fixed, a[k].cpu().numpy(), b[k].cpu().numpy()),
                  f"u/v problem {B}x{M}x{N} lane {k} is not uv_safe")
        return K, a, b

    Ku4, au4, bu4 = (x[0] for x in uv_problem(1, 4096, 4096))
    Ku8, au8, bu8 = (x[0] for x in uv_problem(1, 8192, 8192))
    Kub, aub, bub = uv_problem(8, 2048, 2048)
    Ku4h, Kubh = Ku4.to(b16), Kub.to(b16)
    torch.cuda.synchronize()
    for mod in (ub, uf, ur, ug, uuv):
        mod.reset_counts()
    path4 = {}
    t0 = time.perf_counter()
    path4["solve_uv 4096 fp32"] = ops.solve_uv(Ku4, au4, bu4, cfg_fixed)
    path4["solve_uv 4096 fp32 no P"] = ops.solve_uv(Ku4, au4, bu4, cfg_fixed,
                                                    materialize=False)
    path4["solve_uv 4096 bf16"] = ops.solve_uv(Ku4h, au4, bu4, cfg_fixed)
    path4["solve_uv 4096 bf16 no P"] = ops.solve_uv(Ku4h, au4, bu4,
                                                    cfg_fixed,
                                                    materialize=False)
    path4["solve_uv 8192 fp32"] = ops.solve_uv(Ku8, au8, bu8, cfg_fixed)
    for impl in (None, "kernel"):
        path4[f"batched fp32 {impl}"] = ops.solve_uv_batched(
            Kub, aub, bub, cfg_fixed, impl=impl)
        path4[f"batched bf16 {impl}"] = ops.solve_uv_batched(
            Kubh, aub, bub, cfg_fixed, impl=impl)
    torch.cuda.synchronize()
    t_solves4 = time.perf_counter() - t0
    launches4 = {**ub.LAUNCHES, **uf.LAUNCHES, **ur.LAUNCHES, **ug.LAUNCHES,
                 **uuv.LAUNCHES}
    plain4 = {**ub.PLAIN_CALLS, **uf.PLAIN_CALLS, **ur.PLAIN_CALLS,
              **ug.PLAIN_CALLS, **uuv.PLAIN_CALLS}
    log("launches", f"fourth path {launches4}; plain versions {plain4}")
    check(set(launches4) == set(KERNELS), "kernel counters incomplete")
    check(all(launches4[k] > 0 for k in FOURTH),
          f"a kernel of the fourth path never launched: {launches4}")
    check(not any(plain4.values()),
          f"a plain version ran on the card path: {plain4}")

    def plain_uv(K, a, b):
        """The plain u/v iterates on the card: v from
        sinkhorn_uot_uv_fused, u one plain half-iteration further (the
        extra pass solve_uv takes for the final u), and their coupling."""
        _, (_, v), _ = sinkhorn_uot_uv_fused(K, a, b, cfg_fixed)
        Kf = K.float()
        u = rescale_factors(a, Kf @ v, cfg_fixed.fi)
        return u[:, None] * Kf * v[None, :], u, v

    def held_uv(got, K, a, b, what):
        """Per entry: u, v within UV_RTOL and P within P_RTOL of the plain
        iterates (a bf16 K is upcast exactly on both sides, so the fp32
        bars hold for it too); returns the worst relative errors."""
        P, (u, v) = got
        Pp, up, vp = plain_uv(K, a, b)
        r = [each(u, up, UV_RTOL, f"{what} u"), each(v, vp, UV_RTOL,
                                                      f"{what} v")]
        if P is not None:
            check(P.dtype == f32 and P.shape == K.shape
                  and bool(torch.isfinite(P).all()), f"{what}: P output")
            r.append(each(P, Pp, P_RTOL, f"{what} P"))
            if K.dtype == b16:
                within(P, Pp, b16, what, call=False)
        return r

    for name, K, a, b in (("solve_uv 4096 fp32", Ku4, au4, bu4),
                          ("solve_uv 4096 fp32 no P", Ku4, au4, bu4),
                          ("solve_uv 4096 bf16", Ku4h, au4, bu4),
                          ("solve_uv 4096 bf16 no P", Ku4h, au4, bu4),
                          ("solve_uv 8192 fp32", Ku8, au8, bu8)):
        got = path4[name]
        check((got[0] is None) == name.endswith("no P"),
              f"{name}: materialize flag")
        r = held_uv(got, K, a, b, name)
        log("solve_uv", f"{name}: per entry max rel err vs plain u "
            f"{r[0]:.3g} v {r[1]:.3g}"
            + (f" P {r[2]:.3g}" if len(r) > 2 else " (no P)"))
    for name in [k for k in path4 if k.startswith("batched")]:
        P, (u, v) = path4[name]
        Kx = Kubh if "bf16" in name else Kub
        worst = [0.0, 0.0, 0.0]
        for k in range(Kx.shape[0]):
            r = held_uv((P[k], (u[k], v[k])), Kx[k], aub[k], bub[k],
                        f"solve_uv_batched {name} lane {k}")
            worst = [max(x, y) for x, y in zip(worst, r)]
        log("solve_uv_batched", f"B=8 2048x2048 {name}: per entry max rel "
            f"err vs plain u {worst[0]:.3g} v {worst[1]:.3g} P "
            f"{worst[2]:.3g}")
    check(all(torch.equal(path4[f"batched {d} None"][0],
                          path4[f"batched {d} kernel"][0])
              for d in ("fp32", "bf16")),
          "solve_uv_batched impl None and 'kernel' differ")
    log("solve_uv", f"the nine u/v solves took {t_solves4 * 1e3:.1f} ms "
        f"(host clock, first calls included)")
    del path4, Ku8, au8, bu8
    torch.cuda.synchronize()

    # ---- 16. times of kernels l, m, n, o; the u/v pass against MAP-UOT -------
    for (B, M, N) in ((1, 4096, 4096), (8, 2048, 2048)):
        mn = B * M * N
        single = B == 1
        au = torch.full((B, M), 1.0 / M, device=dev)
        vu = torch.rand((B, N), generator=gen, device=dev) + 0.5
        uu = torch.rand((B, M), generator=gen, device=dev) + 0.5
        for dt in (f32, b16):
            s = torch.empty((), dtype=dt).element_size()
            sets = cold(lambda: ((torch.rand((B, M, N), generator=gen,
                                              device=dev) + 0.1).to(dt),),
                        mn * s)
            names, it_fn, it_plain, mat_fn, mat_plain = uv_kernels(B)
            if single:
                sets = [(K[0],) for (K,) in sets]
                vx, ax, ux = vu[0], au[0], uu[0]
            else:
                vx, ax, ux = vu, au, uu
            plan = ub.plan_for(B, M, N, s)
            shape = [B, M, N] if not single else [M, N]
            table = {
                # per entry: K*v and its sum, K*u and its sum
                names[0]: dict(fn=lambda K: it_fn(K, vx, ax, fi=0.95),
                               plain=lambda K: it_plain(K, vx, ax, fi=0.95),
                               library=None,
                               bytes=mn * s + B * (2 * M + 2 * N) * 4,
                               flops=4 * mn, shape=shape,
                               variant=f"{plan.variant}, {B * plan.ctas} "
                                       f"blocks"),
                names[1]: dict(fn=lambda K: mat_fn(K, ux, vx),
                               plain=lambda K: mat_plain(K, ux, vx),
                               library=None,
                               bytes=mn * (s + 4) + B * (M + N) * 4,
                               flops=2 * mn, shape=shape,
                               variant="P fp32"),
            }
            for name, t in table.items():
                rows.append(timed_row(name, t, dt, sets))
            if not single:
                # context: the two cuBLAS matrix-vector products of one u/v
                # iteration at n's shape (bf16 K with bf16 vectors)
                vc, uc = vu.to(dt)[:, :, None], uu.to(dt)[:, None, :]
                ms_kv = time_ms(lambda K: torch.matmul(K, vc), sets)
                ms_ut = time_ms(lambda K: torch.matmul(uc, K), sets)
                log("time", f"cuBLAS at {B}x{M}x{N} {str(dt)[6:]} "
                    f"({len(sets)} input copies): K @ v {ms_kv:.4f} ms, "
                    f"u @ K {ms_ut:.4f} ms, sum {ms_kv + ms_ut:.4f} ms "
                    f"(two reads of K; context, not the kernel's library "
                    f"call)")
            del sets

    # the u/v solve against MAP-UOT's at one shape, on device tensors (a
    # line, not a claim): 20 iterations each, order uv, fused, fused, uv
    def solve_ms(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "uv":
            ops.solve_uv_batched(Kub, aub, bub, cfg_fixed)
        else:
            ops.solve_fused_batched(Kub, aub, bub, cfg_fixed)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    solve_ms("uv"), solve_ms("fused")                # warm up
    order = ("uv", "fused", "fused", "uv")
    uv_ms = [(k, solve_ms(k)) for k in order]
    log("e2e", f"B=8 2048x2048 fp32, {cfg_fixed.num_iters} iterations, "
        f"device tensors (host clock, order {', '.join(order)}): "
        + "; ".join(f"solve_{'uv' if k == 'uv' else 'fused'}_batched "
                    f"{ms:.2f} ms" for k, ms in uv_ms)
        + " — the u/v pass reads K once an iteration, MAP-UOT's pass reads "
        "and writes the coupling")
    del Kub, Kubh, Ku4, Ku4h

    # ---- 17. result lines ------------------------------------------------------
    second = {"colsum", "fused_iteration", "resident_solve",
              "resident_stepped"}
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r32 = next(r for r in rows if r["name"] == name
                   and r["dtype"] == "float32")
        r16 = next(r for r in rows if r["name"] == name
                   and r["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces,
            "launches": (launches4 if name in FOURTH else launches3
                         if name in THIRD else launches2
                         if name in second else launches)[name],
            "max_abs_err": errs[name], "ms": r32["ms"],
            "plain_ms": r32["plain_ms"], "bound_ms": r32["bound_ms"],
            "bound_by": r32["bound_by"], "library_ms": r32["library_ms"],
            "shape": r32["shape"], "dtype": "float32",
            "variant": r32["variant"], "achieved_GBps": r32["achieved_GBps"],
            "bf16_ms": r16["ms"], "bf16_bound_ms": r16["bound_ms"],
            "bf16_plain_ms": r16["plain_ms"],
            "bf16_library_ms": r16["library_ms"],
            "main_path": ("fourth" if name in FOURTH else "third"
                          if name in THIRD else "second"
                          if name in second else "first")})
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
