#!/usr/bin/env python3
"""A/B of the UOTScheduler's host copies on one NVIDIA GPU.

    python3 scripts/ab_scheduler_host_copies.py

Serves the same 64 fp32 requests (1500-2048 per side, pools of 8 lanes,
chunks of 4 iterations, tol 1e-4) two ways, in ten pairs within one
process after one warm-up run of each (the side that runs first
alternates between pairs), and prints the wall time, the scheduler's host
phases
(``profile.phase.serve.{evict,admit,chunk}``) and the parts of ``evict``
(flag read-back, tile fetch, per-request host copy) of each run:

* ``parent``: each round's admissions padded into a fresh ``np.zeros``
  stack and copied again by ``pin_memory()``; results copied out of the
  pinned tile by numpy (the port's first version);
* ``change``: admissions copied once, by torch, into the pool's reused
  pinned staging buffer (``_LanePool.stage``); results copied out by
  torch (``scheduler._host_coupling``), as shipped.

Needs CUDA; exits non-zero without it.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_scheduler_host_copies: CUDA is not available",
              file=sys.stderr)
        return 2
    from repro_torch.core import UOTConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import UOTScheduler
    from repro_torch.serve import scheduler as smod

    def parent_admit(self, bucket, placed):
        pool = self._pools[bucket]
        Mb, Nb = bucket
        k = len(placed)
        Kp = np.zeros((k, Mb, Nb), np.float32)
        ap = np.zeros((k, Mb), np.float32)
        bp = np.zeros((k, Nb), np.float32)
        for j, (_, req) in enumerate(placed):
            M, N = req.shape
            Kp[j, :M, :N] = req.K
            ap[j, :M] = req.a
            bp[j, :N] = req.b
        dev = self.device
        ops.lane_admit(pool.state, [lane for lane, _ in placed],
                       ops.to_device(Kp, dev), ops.to_device(ap, dev),
                       ops.to_device(bp, dev))

    def parent_extract(P, M, N):
        P = P[:M, :N]
        return P.numpy().copy() if P.dtype == torch.float32 else \
            P.float().numpy()

    variants = {
        "parent": (parent_admit, parent_extract),
        "change": (smod.UOTScheduler._admit_dense, smod._host_coupling),
    }
    parts = {"flags": 0.0, "fetch": 0.0, "extract": 0.0}

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                parts[key] += time.perf_counter() - t0
        return run

    read_flags = smod.UOTScheduler._read_flags
    fetch_lanes = smod.UOTScheduler._fetch_lanes
    smod.UOTScheduler._read_flags = timed("flags", read_flags)
    smod.UOTScheduler._fetch_lanes = timed("fetch", fetch_lanes)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    reg = 0.05
    reqs = []
    for M, N in torch.randint(1500, 2049, (64, 2), generator=gen,
                              device=dev).tolist():
        peak = 1 + 5 * torch.rand((), generator=gen, device=dev)
        C = torch.rand((M, N), generator=gen, device=dev) * peak
        a = torch.rand(M, generator=gen, device=dev) + 0.5
        b = torch.rand(N, generator=gen, device=dev) + 0.5
        a, b = a / a.sum(), b / b.sum() * 1.2
        K = torch.exp(-C / reg) * a[:, None] * b[None, :]
        reqs.append((K.cpu().numpy(), a.cpu().numpy(), b.cpu().numpy()))

    def serve(name):
        admit, extract = variants[name]
        smod.UOTScheduler._admit_dense = admit
        smod._host_coupling = timed("extract", extract)
        parts.update(flags=0.0, fetch=0.0, extract=0.0)
        sched = UOTScheduler(UOTConfig(reg=reg, reg_m=1.0, num_iters=100,
                                       tol=1e-4),
                             lanes_per_pool=8, chunk_iters=4, m_bucket=512,
                             n_bucket=512)
        out = {}
        t0 = time.perf_counter()
        for w in range(8):
            for K, a, b in reqs[w * 8:(w + 1) * 8]:
                sched.submit(K, a, b)
            out.update(sched.step())
        out.update(sched.run())
        wall = time.perf_counter() - t0
        if len(out) != len(reqs):
            raise AssertionError(f"{name}: {len(out)} of {len(reqs)} served")
        phases = {p: sched.obs.registry.histogram(
            f"profile.phase.serve.{p}").sum for p in ("evict", "admit",
                                                      "chunk")}
        phases.update({f"evict.{k}": v for k, v in parts.items()})
        return wall, phases

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], check=True, capture_output=True, text=True).stdout.strip()
    print(f"[ab] {card}", flush=True)
    serve("parent")
    serve("change")
    walls = {"parent": [], "change": []}
    for pair in range(10):
        order = ("parent", "change") if pair % 2 == 0 else ("change",
                                                           "parent")
        for name in order:
            wall, ph = serve(name)
            walls[name].append(wall)
            print(f"[ab] pair {pair} {name}: 64 fp32 requests "
                  f"{wall * 1e3:.1f} ms ({64 / wall:.1f} req/s); host phases "
                  + ", ".join(f"{k} {v * 1e3:.1f} ms"
                              for k, v in ph.items()), flush=True)
    wins = sum(c < p for p, c in zip(walls["parent"], walls["change"]))
    q1, q3 = np.percentile(walls["parent"], [25, 75])
    print(f"[ab] medians parent {np.median(walls['parent']) * 1e3:.1f} ms, "
          f"change {np.median(walls['change']) * 1e3:.1f} ms; change faster "
          f"in {wins}/10 pairs; parent quartile spread "
          f"{(q3 - q1) * 1e3:.1f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
