"""Least-squares and linear-regression models.

Counterpart of ``albatross_tpu.models.least_squares``: min_x ||y - A x||^2
with the rows of A as features, by ``torch.linalg.lstsq``.  On the card
lstsq has only the QR driver ``gels``, which needs a full-rank A; on the
CPU the default driver is the rank-revealing ``gelsy``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.distributions import MarginalDistribution
from .base import ModelBase


@dataclasses.dataclass(frozen=True)
class LeastSquaresFit:
    coefs: torch.Tensor


class LeastSquares(ModelBase):
    """Least squares with the features as the design matrix's rows."""

    @property
    def model_name(self):
        return "least_squares"

    def convert_features(self, features) -> torch.Tensor:
        A = torch.as_tensor(features)
        return A[:, None] if A.ndim == 1 else A

    def _fit_impl(self, features, targets: MarginalDistribution):
        A = self.convert_features(features)
        return LeastSquaresFit(torch.linalg.lstsq(A, targets.mean[:, None]).solution[:, 0])

    def _predict_mean(self, features, fit: LeastSquaresFit):
        return self.convert_features(features) @ fit.coefs


class LinearRegression(LeastSquares):
    """Design rows [1, x]: offset and slope."""

    @property
    def model_name(self):
        return "linear_regression"

    def convert_features(self, features) -> torch.Tensor:
        x = torch.as_tensor(features).reshape(-1)
        return torch.stack([torch.ones_like(x), x], dim=1)
