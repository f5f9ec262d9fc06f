"""Mean functions.

Counterpart of ``albatross_tpu.kernels.means``: a ``MeanFunction`` maps a
feature batch to a mean vector in the features' float dtype and on their
device; ``add_to`` / ``remove_from`` are the helpers GP fit and predict
use.  Means compose by ``+`` and ``*``.
"""

from __future__ import annotations

import torch

from ..core.dataset import feature_count, float_like
from ..core.module import Module
from ..core.parameters import Parameter
from ..core.priors import GaussianPrior
from .distances import as_matrix
from .features import strip_measurement


class MeanFunction(Module):
    def _mean(self, X) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, X) -> torch.Tensor:
        X, _ = strip_measurement(X)
        return self._mean(X)

    def add_to(self, X, targets: torch.Tensor) -> torch.Tensor:
        return targets + self(X)

    def remove_from(self, X, targets: torch.Tensor) -> torch.Tensor:
        return targets - self(X)

    def __add__(self, other):
        return SumMean(self, other)

    def __mul__(self, other):
        return ProductMean(self, other)


class ZeroMean(MeanFunction):
    @property
    def name(self):
        return "zero"

    def _mean(self, X):
        return torch.zeros(feature_count(X), **float_like(X))


class ConstantMean(MeanFunction):
    def __init__(self, value=0.0):
        self.mean_value = Parameter(value)

    @property
    def name(self):
        return "constant_mean"

    def _mean(self, X):
        return torch.zeros(feature_count(X), **float_like(X)) + self.mean_value.value


class LinearMean(MeanFunction):
    """slope * x + offset for scalar features."""

    def __init__(self, slope=0.0, offset=0.0):
        self.slope = Parameter(slope, GaussianPrior(0.0, 1000.0))
        self.offset = Parameter(offset, GaussianPrior(0.0, 1000.0))

    @property
    def name(self):
        return "linear"

    def _mean(self, X):
        return self.slope.value * as_matrix(X)[:, 0] + self.offset.value


class SumMean(MeanFunction):
    def __init__(self, lhs: MeanFunction, rhs: MeanFunction):
        self.lhs = lhs
        self.rhs = rhs

    @property
    def name(self):
        return f"({self.lhs.name}+{self.rhs.name})"

    def _mean(self, X):
        return self.lhs._mean(X) + self.rhs._mean(X)


class ProductMean(MeanFunction):
    def __init__(self, lhs: MeanFunction, rhs: MeanFunction):
        self.lhs = lhs
        self.rhs = rhs

    @property
    def name(self):
        return f"({self.lhs.name}*{self.rhs.name})"

    def _mean(self, X):
        return self.lhs._mean(X) * self.rhs._mean(X)
