#!/usr/bin/env python3
"""Sweep the launch plans of the streamed kernels a-d on one GPU.

    python3 scripts/sweep_stream_plans.py

For one 4096x4096 problem (kernels a and b) and a stack of 8 at 2048x2048
(kernels c and d), fp32 and bf16, it launches each kernel through its C launcher
with a range of rows per block (so a range of grid sizes and of partial
column-sum rows), times each with CUDA events (rotating through copies of
the input that span three times the L2, so each call reads device
memory), and prints the time, the
achieved rate against the bytes the call must move, and which row count
the shipped plan (``uot_batched.plan_colsum``, ``uot_batched.plan_for``)
picks. The numbers behind the plans' choices in PERF.md come from here.
Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_stream_plans: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import uot_batched as ub

    lib = _build.load()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    def time_ms(fn, As, reps=30, warm=5):
        """ms per call, the calls taking the copies in ``As`` in turn"""
        for i in range(warm):
            fn(As[i % len(As)])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)   # the host queues ahead of the card
        start.record()
        for i in range(reps):
            fn(As[i % len(As)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for dt in (torch.float32, torch.bfloat16):
        s = torch.empty((), dtype=dt).element_size()
        code = {torch.float32: 0, torch.bfloat16: 1}[dt]
        for kernel, (B, M, N) in (("a", (1, 4096, 4096)),
                                  ("b", (1, 4096, 4096)),
                                  ("c", (8, 2048, 2048)),
                                  ("d", (8, 2048, 2048))):
            # copies spanning three times the L2: each call reads HBM
            As = [(torch.rand((B, M, N), device=dev) + 0.1).to(dt)
                  for _ in range(-(-3 * L2_BYTES // (B * M * N * s)))]
            fcol = torch.ones((B, N), device=dev)
            a = torch.full((B, M), 1.0 / M, device=dev)
            out = torch.empty((B, N), device=dev)
            if kernel in "ac":
                shipped = ub.plan_colsum(B, M, N, s)
                vec, bm = shipped.vec, 1
                nbytes = B * M * N * s + B * N * 4
            else:
                shipped = ub.plan_for(B, M, N, s)
                vec, bm = shipped.vec, shipped.block_m
                nbytes = 2 * B * M * N * s + 2 * B * N * 4 + B * M * 4
            for rows in sorted({bm * k for k in (1, 2, 3, 4, 6, 8, 12, 16,
                                                 24, 32, 48, 64, 96, 128)}
                               | {shipped.rows_per_cta}):
                R = -(-M // rows)
                if rows > M or R < 2:
                    continue
                partial = torch.empty((B, R, N), device=dev)
                if kernel == "a":
                    def fn(A):
                        return lib.uot_fused_colsum(
                            A.data_ptr(), partial.data_ptr(), out.data_ptr(),
                            M, N, code, vec, rows, R, stream)
                    blocks = R * -(-(N // vec) // ub.THREADS)
                elif kernel == "c":
                    def fn(A):
                        return lib.uot_batched_colsum(
                            A.data_ptr(), partial.data_ptr(), out.data_ptr(),
                            B, M, N, code, vec, rows, R, stream)
                    blocks = B * R * -(-(N // vec) // ub.THREADS)
                elif kernel == "b":
                    def fn(A):
                        return lib.uot_fused_iteration(
                            A.data_ptr(), fcol.data_ptr(), a.data_ptr(),
                            out.data_ptr(), partial.data_ptr(), M, N, code,
                            vec, bm, rows, R, int(shipped.one_pass), 0.95, 0,
                            stream)
                    blocks = R
                else:
                    def fn(A):
                        return lib.uot_batched_fused_iteration(
                            A.data_ptr(), fcol.data_ptr(), a.data_ptr(), None,
                            out.data_ptr(), None, partial.data_ptr(), B, M,
                            N, code, vec, bm, rows, R,
                            int(shipped.one_pass), 0.95, 0, stream)
                    blocks = R * B
                _build.check(fn(As[0]), f"kernel {kernel}")
                ms = time_ms(fn, As)
                mark = " <- shipped plan" if rows == shipped.rows_per_cta \
                    else ""
                print(f"{kernel} {B}x{M}x{N} {str(dt)[6:]}: rows/block "
                      f"{rows:5d} blocks {blocks:5d} partial rows {R:4d}: "
                      f"{ms:.4f} ms, {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s "
                      f"(bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)"
                      f"{mark}", flush=True)
            del As
    return 0


if __name__ == "__main__":
    sys.exit(main())
