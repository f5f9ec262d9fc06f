"""Scalar Gaussian density.

Counterpart of ``albatross_tpu.stats.gaussian``.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def _as_float(x) -> torch.Tensor:
    """A float tensor as it is; anything else (numbers, arrays, integer
    tensors) in f64, as the JAX package's x64 mode takes them."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x
    return torch.as_tensor(x).to(torch.float64)


def gaussian_log_pdf(deviation, variance):
    deviation = _as_float(deviation)
    variance = torch.as_tensor(variance, dtype=deviation.dtype, device=deviation.device)
    return -0.5 * (LOG_2PI + torch.log(variance) + deviation * deviation / variance)


def gaussian_pdf(deviation, variance):
    """N(0, variance) density at ``deviation``."""
    return torch.exp(gaussian_log_pdf(deviation, variance))
