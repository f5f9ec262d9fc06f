"""Chebyshev polynomial evaluation and basis matrices.

Counterpart of ``albatross_tpu.utils.chebyshev`` (the reference's
``polynomial/chebyshev.hpp``), in torch ops on the input's device.
Numbers that are not a float tensor are taken at f64.
"""

from __future__ import annotations

import torch


def _as_float(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x
    return torch.as_tensor(x, dtype=torch.float64)


def chebyshev_t(n: int, x) -> torch.Tensor:
    """T_n(x) by the three-term recurrence."""
    x = _as_float(x)
    if n == 0:
        return torch.ones_like(x)
    t_prev, t = torch.ones_like(x), x
    for _ in range(1, n):
        t_prev, t = t, 2.0 * x * t - t_prev
    return t


def chebyshev_u(n: int, x) -> torch.Tensor:
    """U_n(x)."""
    x = _as_float(x)
    if n == 0:
        return torch.ones_like(x)
    u_prev, u = torch.ones_like(x), 2.0 * x
    for _ in range(1, n):
        u_prev, u = u, 2.0 * x * u - u_prev
    return u


def chebyshev_t_phi(x, order: int, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    """Basis matrix Phi[i, k] = T_k(x_i scaled from [lo, hi] to [-1, 1]),
    k = 0..order-1."""
    x = _as_float(x).reshape(-1)
    scaled = 2.0 * (x - lo) / (hi - lo) - 1.0
    return torch.stack([chebyshev_t(k, scaled) for k in range(order)], dim=1)
