"""Kolmogorov-Smirnov statistic against Uniform(0, 1).

Counterpart of ``albatross_tpu.stats.ks_test``.
"""

from __future__ import annotations

import torch


def uniform_ks_test(samples) -> torch.Tensor:
    """sup |F_empirical(x) - x| over the sorted samples."""
    s = torch.sort(torch.as_tensor(samples)).values
    n = s.shape[0]
    grid_hi = torch.arange(1, n + 1, dtype=s.dtype, device=s.device) / n
    grid_lo = torch.arange(0, n, dtype=s.dtype, device=s.device) / n
    return torch.maximum(torch.max(torch.abs(grid_hi - s)), torch.max(torch.abs(s - grid_lo)))
