"""Quickstart on the PyTorch port: solve an unbalanced optimal transport
problem with MAP-UOT.

Run on a machine with an NVIDIA GPU (the kernels build at first use):

    PYTHONPATH=src python examples/quickstart_torch.py

or on the CPU, where every kernel wrapper takes its plain PyTorch version:

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (UOTConfig, gibbs_kernel, sinkhorn_uot_baseline,
                              sinkhorn_uot_fused)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the card)")
    dev = resolve_device(ap.parse_args().device)

    rng = np.random.default_rng(0)
    # two point clouds with unequal masses -> a genuinely unbalanced problem
    X = torch.tensor(rng.normal(size=(512, 2)), dtype=torch.float32,
                     device=dev)
    Y = torch.tensor(rng.normal(size=(384, 2)), dtype=torch.float32,
                     device=dev) + 1.0
    a = torch.full((512,), 1.0 / 512, device=dev)
    b = torch.full((384,), 1.3 / 384, device=dev)

    C = torch.cdist(X, Y) ** 2          # squared Euclidean cost
    C = C / C.max()
    cfg = UOTConfig(reg=0.05, reg_m=1.0, num_iters=200)
    A0 = gibbs_kernel(C, cfg.reg) * (a[:, None] * b[None, :])

    # 1) POT-style 4-pass baseline
    P_base, _ = sinkhorn_uot_baseline(A0, a, b, cfg)
    # 2) MAP-UOT fused (paper Algorithm 1): the same iterates, one pass
    P_fused, _ = sinkhorn_uot_fused(A0, a, b, cfg)
    # 3) the streamed kernels a and b (their plain versions on the CPU)
    P_kernel, _ = ops.solve_fused(A0, a, b, cfg, device=dev)
    # 4) impl='auto': 512x384 is over one block's shared memory, so it
    #    streams; the 96x384 corner fits and runs on the resident kernel f
    P_auto, _ = ops.solve_fused(A0[:96], a[:96], b, cfg, impl="auto",
                                device=dev)
    P_ref96, _ = sinkhorn_uot_fused(A0[:96], a[:96], b, cfg)

    print("device:", dev)
    print("max |baseline - fused|:", float((P_base - P_fused).abs().max()))
    print("max |fused - kernel|  :", float((P_fused - P_kernel).abs().max()))
    print("max |fused - resident| (96x384):",
          float((P_ref96 - P_auto).abs().max()),
          " dispatch:", ops.dispatch_stats())
    print("coupling mass:", float(P_fused.sum()),
          " (marginal masses: 1.0 / 1.3)")
    print("transport cost <C,P>:", float((C * P_fused).sum()))
    print("balanced-sense marginal error:",
          float((P_fused.sum(1) - a).abs().sum()
                + (P_fused.sum(0) - b).abs().sum()))


if __name__ == "__main__":
    main()
