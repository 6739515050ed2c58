#!/usr/bin/env python3
"""Time the streamed kernels c, d, e of one source tree on one GPU.

    python3 scripts/ab_stream_kernels.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so two trees, for instance a commit and its parent unpacked beside it, are
timed by the same yardstick: in one call, run parent, change, change,
parent. For a stack of 8 at 2048x2048, fp32 and bf16, it times
``batched_colsum``, ``batched_fused_iteration`` and
``batched_fused_iteration_frow`` with CUDA events, rotating through copies
of the input that span three times the L2 (so each call reads device
memory), after a spin kernel that lets the host queue ahead of the card.
Prints the card's name and power limit, then one JSON line of ms per
kernel and dtype. Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("ab_stream_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import uot_batched as ub

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"], check=True,
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, sets, warm=3):
        for i in range(warm):
            fn(*sets[i % len(sets)])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(args.reps):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    B, M, N = 8, 2048, 2048
    out = {"src": os.path.abspath(args.src), "shape": [B, M, N]}
    for dt in (torch.float32, torch.bfloat16):
        s = torch.empty((), dtype=dt).element_size()
        fcol = torch.ones((B, N), device=dev)
        a = torch.full((B, M), 1.0 / M, device=dev)
        live = torch.ones(B, dtype=torch.bool, device=dev)
        sets = [((torch.rand((B, M, N), generator=gen, device=dev) + 0.1)
                 .to(dt), torch.zeros((B, N), device=dev))
                for _ in range(-(-3 * L2_BYTES // (B * M * N * s)))]
        for name, fn in (
                ("batched_colsum", lambda A, _: ub.batched_colsum(A)),
                ("batched_fused_iteration",
                 lambda A, _: ub.batched_fused_iteration(A, fcol, a,
                                                         fi=0.95)),
                ("batched_fused_iteration_frow",
                 lambda A, k: ub.batched_fused_iteration_frow(
                     A, fcol, a, live, k, fi=0.95))):
            out[f"{name} {str(dt)[6:]}"] = time_ms(fn, sets)
        del sets
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
