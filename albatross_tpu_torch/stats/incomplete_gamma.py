"""Regularized incomplete gamma.

Counterpart of ``albatross_tpu.stats.incomplete_gamma``: torch's
``special.gammainc`` and ``lgamma`` in place of ``jax.scipy.special``.
"""

from __future__ import annotations

import torch


def regularized_lower_incomplete_gamma(a, z):
    """P(a, z) = gamma(a, z) / Gamma(a)."""
    return torch.special.gammainc(a, z)


def lower_incomplete_gamma(a, z):
    """gamma(a, z), unnormalized."""
    return torch.special.gammainc(a, z) * torch.exp(torch.lgamma(a))
