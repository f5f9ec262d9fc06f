"""Chi-squared CDF.

Counterpart of ``albatross_tpu.stats.chi_squared``.
"""

from __future__ import annotations

import torch

from ..ops.linalg import CholeskyFactor
from .gaussian import _as_float
from .incomplete_gamma import regularized_lower_incomplete_gamma


def chi_squared_cdf_value(x, k):
    """CDF of chi^2 with k degrees of freedom at x: P(k / 2, x / 2).  k = 0
    is a point mass at zero (CDF 1); x < 0 and NaN give NaN.  A number
    ``x`` is taken in f64."""
    x = _as_float(x)
    k = torch.as_tensor(k, dtype=x.dtype, device=x.device)
    cdf = torch.where(k <= 0.0, torch.ones_like(x),
                      regularized_lower_incomplete_gamma(k / 2.0, torch.clamp_min(x, 0.0) / 2.0))
    return torch.where(torch.isnan(x) | (x < 0.0), torch.full_like(cdf, float("nan")), cdf)


def chi_squared_cdf(deviation, covariance) -> torch.Tensor:
    """CDF of the Mahalanobis norm dev^T Sigma^-1 dev under chi^2(n)."""
    white = CholeskyFactor.factorize(covariance).sqrt_solve(deviation)
    return chi_squared_cdf_value(torch.sum(white * white), deviation.shape[0])
