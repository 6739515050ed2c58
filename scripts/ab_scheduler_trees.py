#!/usr/bin/env python3
"""A/B of the UOTScheduler's serving run between two source trees, one GPU.

    python3 scripts/ab_scheduler_trees.py --parent DIR --change DIR \
        [--pairs 10] [--dtype float32|bfloat16]

Each DIR is a ``src`` directory holding ``repro_torch`` (for instance a
commit and its parent unpacked with ``git archive``). For each of
``--pairs`` pairs it starts one process per tree, alternating which tree
runs first. A process builds (or loads) its tree's kernels, makes the
same 64 requests from a fixed seed (1500-2048 per side, on the card,
then copied to the host), serves 16 of them once to warm up, then serves
all 64 as ``chip_smoke.py``'s first-slice scheduler run does (8 waves
between scheduler rounds, pools of 8 lanes, chunks of 4 iterations, tol
1e-4), and reports the wall time and the scheduler's host phases. Prints
one line per run, then the card's name and power limit, and one JSON line
with each side's median and quartiles and how many pairs the change won.
Needs CUDA; exits non-zero without it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def worker(src: str, dtype_name: str) -> int:
    sys.path.insert(0, os.path.abspath(src))
    import torch
    if not torch.cuda.is_available():
        print("ab_scheduler_trees: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import UOTConfig
    from repro_torch.kernels import _build
    from repro_torch.serve import UOTScheduler

    _build.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    reg = 0.05
    reqs = []
    for M, N in torch.randint(1500, 2049, (64, 2), generator=gen,
                              device=dev).tolist():
        C = torch.rand((M, N), generator=gen, device=dev) * (
            1.0 + 5.0 * torch.rand((), generator=gen, device=dev))
        a = torch.rand(M, generator=gen, device=dev) + 0.5
        b = torch.rand(N, generator=gen, device=dev) + 0.5
        a, b = a / a.sum(), b / b.sum() * 1.2
        K = torch.exp(-C / reg) * a[:, None] * b[None, :]
        reqs.append((K.cpu().numpy(), a.cpu().numpy(), b.cpu().numpy()))

    def serve(reqs, waves):
        sched = UOTScheduler(UOTConfig(reg=reg, reg_m=1.0, num_iters=100,
                                       tol=1e-4,
                                       dtype=getattr(torch, dtype_name)),
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
        wall = time.perf_counter() - t0
        assert len(out) == len(reqs)
        return sched, wall

    serve(reqs[:16], 2)
    sched, wall = serve(reqs, 8)
    hist = sched.obs.registry.histogram
    print(json.dumps({"wall_ms": wall * 1e3} | {
        ph: hist(f"profile.phase.serve.{ph}").sum * 1e3
        for ph in ("evict", "admit", "chunk")}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--change")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.dtype)
    import numpy as np

    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 getattr(args, side), "--dtype", args.dtype],
                capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout, out.stderr, file=sys.stderr)
                return out.returncode
            r = json.loads(out.stdout.strip().splitlines()[-1])
            runs[side].append(r)
            print(f"pair {i} {side}: " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in r.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"], check=True,
                         capture_output=True, text=True).stdout.strip())
    summary = {"dtype": args.dtype, "pairs": args.pairs, "change_won": sum(
        c["wall_ms"] < p["wall_ms"]
        for p, c in zip(runs["parent"], runs["change"]))}
    for side, rs in runs.items():
        for key in rs[0]:
            q1, med, q3 = np.percentile([r[key] for r in rs], [25, 50, 75])
            summary[f"{side} {key}"] = {"median": med, "q1": q1, "q3": q3}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
