"""Constant and polynomial covariance terms.

Counterpart of ``albatross_tpu.kernels.polynomials``: ``Constant`` is
sigma^2 between any two features of any kind, ``Polynomial`` the sum of
sigma_i^2 (x y)^i over scalar features, and ``ConstantTerm`` the constant's
latent-state feature, at which a fit predicts the constant's value.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import config
from ..core.dataset import feature_count, float_like
from ..core.parameters import Parameter, map_join
from ..core.priors import NonNegativePrior
from .base import CovarianceFunction
from .distances import as_matrix

DEFAULT_SIGMA = 100.0


@dataclasses.dataclass(frozen=True)
class ConstantTerm:
    """A batch of "global constant" features: its covariance with anything
    through ``Constant`` is sigma^2, and every other kernel treats it as
    undefined.  Its marker is NaN, so value-based kernels (equality noise)
    never match it to a real feature.  The default marker lies on
    ``config.device(None)``; pass one on the fit's device and in its dtype
    (``ConstantTerm(torch.full((1,), nan, ...))``) to predict there."""

    marker: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.full((1,), float("nan"), device=config.device(None))
    )

    @property
    def size(self) -> int:
        return self.marker.shape[0]


class Constant(CovarianceFunction):
    """sigma^2 everywhere: a (biased) mean term."""

    def __init__(self, sigma_constant=DEFAULT_SIGMA):
        self.sigma_constant = Parameter(sigma_constant, NonNegativePrior())

    @property
    def name(self):
        return "constant"

    def _sigma2(self):
        s = self.sigma_constant.value
        return s * s

    def _matrix(self, X, Y, x_meas, y_meas):
        return torch.zeros((feature_count(X), feature_count(Y)), **float_like(X)) + self._sigma2()

    def _diag(self, X, x_meas):
        return torch.zeros((feature_count(X),), **float_like(X)) + self._sigma2()

    def state_space_representation(self, X):
        # one pseudo-point stands for the constant's inducing representation
        return torch.zeros((1,), **float_like(X))


class Polynomial(CovarianceFunction):
    """sum_i sigma_i^2 (x y)^i over scalar features, with parameters named
    ``sigma_polynomial_<i>`` as in the reference."""

    _PREFIX = "sigma_polynomial_"

    def __init__(self, order: int, sigma=DEFAULT_SIGMA):
        self.order = int(order)
        self.sigmas = tuple(Parameter(sigma, NonNegativePrior()) for _ in range(self.order + 1))

    @property
    def name(self):
        return f"polynomial_{self.order}"

    def get_params(self):
        return map_join({f"{self._PREFIX}{i}": p for i, p in enumerate(self.sigmas)})

    def _replace_param(self, name, param):
        if not name.startswith(self._PREFIX):
            raise KeyError(name)
        sigmas = list(self.sigmas)
        sigmas[int(name[len(self._PREFIX):])] = param
        return self._replace(sigmas=tuple(sigmas))

    def _matrix(self, X, Y, x_meas, y_meas):
        x, y = as_matrix(X)[:, 0], as_matrix(Y)[:, 0]
        cov = torch.zeros((x.shape[0], y.shape[0]), dtype=x.dtype, device=x.device)
        xp, yp = torch.ones_like(x), torch.ones_like(y)
        for i, p in enumerate(self.sigmas):
            if i > 0:
                xp, yp = xp * x, yp * y
            cov = cov + (p.value * p.value) * xp[:, None] * yp[None, :]
        return cov

    def _diag(self, X, x_meas):
        x = as_matrix(X)[:, 0]
        out, xp = torch.zeros_like(x), torch.ones_like(x)
        for i, p in enumerate(self.sigmas):
            if i > 0:
                xp = xp * x
            out = out + (p.value * p.value) * xp * xp
        return out
