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
10. prints a ``{"kernels": [...]}`` line for all seven kernels, the card's
    name and power limit, and last ``{"ok": true, "device": {...}}``.

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
}


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
    check(all(v > 0 for v in launches.values()),
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
    check(set(launches2) == set(KERNELS), "kernel counters incomplete")
    check(all(v > 0 for v in launches2.values()),
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

    # ---- 10. result lines ------------------------------------------------------
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
            "launches": (launches2 if name in second else launches)[name],
            "max_abs_err": errs[name], "ms": r32["ms"],
            "plain_ms": r32["plain_ms"], "bound_ms": r32["bound_ms"],
            "bound_by": r32["bound_by"], "library_ms": r32["library_ms"],
            "shape": r32["shape"], "dtype": "float32",
            "variant": r32["variant"], "achieved_GBps": r32["achieved_GBps"],
            "bf16_ms": r16["ms"], "bf16_bound_ms": r16["bound_ms"],
            "bf16_plain_ms": r16["plain_ms"],
            "bf16_library_ms": r16["library_ms"],
            "main_path": "second" if name in second else "first"})
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
