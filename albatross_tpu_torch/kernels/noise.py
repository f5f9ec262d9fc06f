"""Noise kernels: IndependentNoise and Nugget.

Counterpart of ``albatross_tpu.kernels.noise``, with its contract: sigma^2
where x == y feature-wise.  With ``assume_unique`` the symmetric call
(``X is Y``) short-circuits to sigma^2 I instead of an N^2 equality mask.
``assume_unique`` is a CONTRACT, not a hint: on a batch with duplicated
feature values, by-value semantics make the covariance singular (a
duplicated pair gets sigma^2 off the diagonal too), while the identity
shortcut gives sigma^2 I -- the two build different matrices.  Deduplicate
or jitter such inputs, or drop ``assume_unique``.
"""

from __future__ import annotations

import torch

from ..core.dataset import feature_count, first_leaf, float_like
from ..core.parameters import Parameter
from ..core.priors import FixedPrior, PositivePrior
from .base import CovarianceFunction

DEFAULT_SIGMA_NOISE = 0.1
DEFAULT_NUGGET_NOISE = 1e-8


def equality_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(N, M) boolean mask of exact feature equality."""
    pair = X[:, None] == Y[None, :]
    while pair.ndim > 2:
        pair = torch.all(pair, dim=-1)
    return pair


class _EqualityNoise(CovarianceFunction):
    _sigma_param: str

    def _sigma2(self):
        sigma = getattr(self, self._sigma_param).value
        return sigma * sigma

    def _matrix(self, X, Y, x_meas, y_meas):
        sigma2 = self._sigma2()
        like = float_like(X)
        if X is Y and self.assume_unique:
            return sigma2 * torch.eye(feature_count(X), **like)
        return sigma2 * equality_matrix(first_leaf(X), first_leaf(Y)).to(like["dtype"])

    def _diag(self, X, x_meas):
        return torch.zeros(feature_count(X), **float_like(X)) + self._sigma2()


class IndependentNoise(_EqualityNoise):
    """sigma^2 iff x == y."""

    _sigma_param = "sigma_independent_noise"

    def __init__(self, sigma_noise=DEFAULT_SIGMA_NOISE, assume_unique=False):
        self.sigma_independent_noise = Parameter(sigma_noise, PositivePrior())
        self.assume_unique = assume_unique

    @property
    def name(self):
        return "independent_noise"


class Nugget(_EqualityNoise):
    """Tiny fixed diagonal jitter for conditioning."""

    _sigma_param = "nugget_sigma"

    def __init__(self, nugget_sigma=DEFAULT_NUGGET_NOISE, assume_unique=False):
        self.nugget_sigma = Parameter(nugget_sigma, FixedPrior())
        self.assume_unique = assume_unique

    @property
    def name(self):
        return "nugget"
