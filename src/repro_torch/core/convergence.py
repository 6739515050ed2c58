"""Convergence metrics for UOT solves (PyTorch port of
``repro.core.convergence``: the per-lane drift the batched and stepped
solvers stop on)."""
from __future__ import annotations

import torch


def lane_factor_drift(factors: torch.Tensor,
                      prev_factors: torch.Tensor) -> torch.Tensor:
    """Per-lane stationarity drift of successive rescale factors.

    ``factors`` / ``prev_factors`` are (B, K) stacks of per-lane row
    factors from iterations t and t-1. Returns (B,) ``max_k |f_t - f_{t-1}|``
    — the batched form of the single-problem solvers' stopping criterion.
    Zero-padded rows carry factor exactly 1 in every iteration and
    contribute 0 to the max.
    """
    return torch.amax(torch.abs(factors - prev_factors), dim=-1)
