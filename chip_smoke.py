#!/usr/bin/env python3
"""Drive the PyTorch port of MAP-UOT (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port starts on the card. It

1. prints the card (``nvidia-smi``), the torch / CUDA / nvcc versions, and
   builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed);
2. holds kernels c, d, e (``batched_colsum``, ``batched_fused_iteration``,
   ``batched_fused_iteration_frow``) against their plain PyTorch versions
   on the card, fp32 and bf16, at ragged and wide shapes; frozen lanes and
   repeated launches must be bitwise equal;
3. drives the main path with the launch counters zeroed just before and
   read just after: ``solve_fused_batched`` (B=1 4096x4096 and B=8
   2048x2048, tol None and 1e-4), a ``UOTBatchEngine`` flush of 32 ragged
   requests, and ``UOTScheduler`` runs of 64 requests arriving over time
   (pools of 8 lanes, fp32 and bf16). Every kernel must have launched, and
   no plain version may have run;
4. checks every result against plain solves on the card;
5. times each kernel with CUDA events beside its bound, its plain version
   and the one PyTorch call that computes the same function (if any);
6. traces a scheduler run with ``torch.profiler``: device-busy share and
   the top device operations;
7. prints a ``{"kernels": [...]}`` line, the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

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
F32_RTOL, F32_ATOL = 1e-5, 1e-7  # one kernel call, fp32
SOLVE_RTOL = 1e-4                # whole solves, fp32
BF16_POINT, BF16_MASS = 5e-2, 1e-2
SOURCE = "src/repro_torch/kernels/csrc/uot_batched.cu"
REPLACES = {"batched_colsum": "src/repro/kernels/uot_batched.py:194",
            "batched_fused_iteration": "src/repro/kernels/uot_batched.py:66",
            "batched_fused_iteration_frow":
                "src/repro/kernels/uot_batched.py:132"}


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

    def within(got, want, dtype, what, *, call=True):
        got, want = got.float(), want.float()
        if dtype == torch.bfloat16:
            point = float((got - want).abs().max() / want.abs().max())
            mass = abs(float(got.sum() - want.sum())) / abs(float(want.sum()))
            check(point <= BF16_POINT and mass <= BF16_MASS,
                  f"{what}: bf16 pointwise {point:.3g} mass {mass:.3g}")
        elif call:
            check(torch.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL),
                  f"{what}: max abs err {float((got - want).abs().max()):.3g}")
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
    def time_ms(fn, reps=20, warm=3):
        for _ in range(warm):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    B, M, N = 8, 2048, 2048
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        s = torch.empty((), dtype=dt).element_size()
        A = (torch.rand((B, M, N), generator=gen, device=dev) + 0.1).to(dt)
        fcol = torch.ones((B, N), device=dev)
        a = torch.full((B, M), 1.0 / M, device=dev)
        live = torch.ones(B, dtype=torch.bool, device=dev)
        carried = torch.zeros((B, N), device=dev)
        mn = B * M * N
        table = {
            "batched_colsum": dict(
                fn=lambda: ub.batched_colsum(A),
                plain=lambda: ub.batched_colsum_plain(A),
                library=lambda: A.float().sum(1),
                bytes=mn * s + B * N * 4, flops=mn),
            "batched_fused_iteration": dict(
                fn=lambda: ub.batched_fused_iteration(A, fcol, a, fi=0.95),
                plain=lambda: ub.batched_fused_iteration_plain(A, fcol, a,
                                                               fi=0.95),
                library=None,
                bytes=2 * mn * s + 2 * B * N * 4 + B * M * 4, flops=5 * mn),
            "batched_fused_iteration_frow": dict(
                fn=lambda: ub.batched_fused_iteration_frow(
                    A, fcol, a, live, carried, fi=0.95),
                plain=lambda: ub.batched_fused_iteration_frow_plain(
                    A, fcol, a, live, carried, fi=0.95),
                library=None,
                bytes=2 * mn * s + 2 * B * N * 4 + 2 * B * M * 4 + B,
                flops=5 * mn),
        }
        for name, t in table.items():
            ms = time_ms(t["fn"])
            plain_ms = time_ms(t["plain"], reps=5, warm=1)
            lib_ms = time_ms(t["library"]) if t["library"] else None
            bound = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["flops"] / FP32_FLOPS) * 1e3
            by = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                  >= t["flops"] / FP32_FLOPS else "operations")
            gbps = t["bytes"] / (ms * 1e-3) / 1e9
            plan = (ub.plan_colsum if name == "batched_colsum"
                    else ub.plan_for)(B, M, N, s)
            log("time", f"{name} {B}x{M}x{N} {str(dt)[6:]}: kernel "
                f"{ms:.4f} ms ({gbps:.0f} GB/s of {t['bytes'] / 1e6:.1f} MB "
                f"modelled), bound {bound:.4f} ms ({by}), plain "
                f"{plain_ms:.4f} ms (not a yardstick), library "
                + (f"{lib_ms:.4f} ms (A.float().sum(1))" if lib_ms is not None
                   else "none (no single PyTorch call computes it)")
                + f"; {plan.variant}, partials "
                f"{plan.partial_bytes(B, N) / 1e6:.2f} MB")
            row = {"name": name, "dtype": str(dt)[6:], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": lib_ms, "achieved_GBps": gbps,
                   "modelled_bytes": t["bytes"], "variant": plan.variant}
            rows.append(row)
        del A

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

    # ---- 7. result lines -------------------------------------------------------
    kernels = []
    for name in REPLACES:
        f32 = next(r for r in rows if r["name"] == name
                   and r["dtype"] == "float32")
        b16 = next(r for r in rows if r["name"] == name
                   and r["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "shape": [B, M, N], "dtype": "float32",
            "variant": f32["variant"], "achieved_GBps": f32["achieved_GBps"],
            "bf16_ms": b16["ms"], "bf16_bound_ms": b16["bound_ms"],
            "bf16_plain_ms": b16["plain_ms"],
            "bf16_library_ms": b16["library_ms"]})
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
