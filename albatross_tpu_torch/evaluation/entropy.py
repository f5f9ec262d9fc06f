"""Differential entropy of Gaussians, H = 1/2 log det(2 pi e Sigma).

Counterpart of ``albatross_tpu.evaluation.entropy``: a 1-D argument is a
variance vector (a diagonal covariance), a 2-D one a dense covariance.
"""

from __future__ import annotations

import math

import torch

from ..ops.compensated import accurate_sum_of_logs
from ..ops.linalg import CholeskyFactor

LOG_2PIE = math.log(2.0 * math.pi * math.e)


def differential_entropy(covariance) -> torch.Tensor:
    covariance = torch.as_tensor(covariance)
    n = covariance.shape[0]
    if covariance.ndim == 1:
        return 0.5 * (n * LOG_2PIE + accurate_sum_of_logs(covariance))
    return 0.5 * (n * LOG_2PIE + CholeskyFactor.factorize(covariance).log_determinant())
