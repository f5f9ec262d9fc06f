"""Radial covariance kernels.

Counterpart of ``albatross_tpu.kernels.radial``: the same parameter names,
defaults, priors and closed forms.  Gram evaluation goes through
``ops.radial_gram.radial_gram`` -- the hand-written CUDA kernel for CUDA
tensors, the closed form for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from ..core.parameters import Parameter
from ..core.priors import NonNegativePrior, PositivePrior
from .base import CovarianceFunction
from .distances import EuclideanDistance

DEFAULT_LENGTH_SCALE = 100000.0
DEFAULT_RADIAL_SIGMA = 10.0


def _guarded(distance, length_scale, value_fn):
    """Evaluate ``value_fn(distance, safe_length_scale)`` with the
    ``length_scale > 0`` guard of the reference closed forms: a
    non-positive length scale gives covariance 0."""
    distance = torch.as_tensor(distance)
    ls = torch.as_tensor(length_scale, dtype=distance.dtype, device=distance.device)
    positive = ls > 0.0
    safe = torch.where(positive, ls, torch.ones_like(ls))
    value = value_fn(distance, safe)
    return torch.where(positive, value, torch.zeros_like(value))


def squared_exponential_covariance(distance, length_scale, sigma=1.0):
    return _guarded(
        distance, length_scale,
        lambda d, ls: sigma * sigma * torch.exp(-torch.square(d / ls)),
    )


def exponential_covariance(distance, length_scale, sigma=1.0):
    return _guarded(
        distance, length_scale,
        lambda d, ls: sigma * sigma * torch.exp(-torch.abs(d / ls)),
    )


def matern_32_covariance(distance, length_scale, sigma=1.0):
    def value(d, ls):
        sqrt_3_d = math.sqrt(3.0) * d / ls
        return sigma * sigma * (1.0 + sqrt_3_d) * torch.exp(-sqrt_3_d)

    return _guarded(distance, length_scale, value)


def matern_52_covariance(distance, length_scale, sigma=1.0):
    def value(d, ls):
        sqrt_5_d = math.sqrt(5.0) * d / ls
        return (
            sigma * sigma * (1.0 + sqrt_5_d + sqrt_5_d * sqrt_5_d / 3.0)
            * torch.exp(-sqrt_5_d)
        )

    return _guarded(distance, length_scale, value)


class _RadialKernel(CovarianceFunction):
    """Shared machinery: Euclidean distance -> profile, and the diagonal."""

    _length_scale_param: str
    _sigma_param: str
    _profile_name: str

    def _init_params(self, length_scale, sigma, distance_metric):
        if not isinstance(distance_metric, EuclideanDistance):
            raise TypeError(
                f"{type(self).__name__}: only EuclideanDistance is ported"
            )
        setattr(self, self._length_scale_param, Parameter(length_scale, PositivePrior()))
        setattr(self, self._sigma_param, Parameter(sigma, NonNegativePrior()))
        self.distance_metric = distance_metric

    def _profile(self, distance, length_scale, sigma):
        raise NotImplementedError

    def _params_values(self):
        ls = getattr(self, self._length_scale_param).value
        sigma = getattr(self, self._sigma_param).value
        return ls, sigma

    @property
    def name(self):
        return f"{self._profile_name}[{self.distance_metric.name}]"

    def _matrix(self, X, Y, x_meas, y_meas):
        from ..ops.radial_gram import radial_gram

        ls, sigma = self._params_values()
        if float(ls) <= 0.0:
            return torch.zeros((X.shape[0], Y.shape[0]), dtype=X.dtype, device=X.device)
        return radial_gram(X, Y, ls, sigma, self._profile_name)

    def _diag(self, X, x_meas):
        ls, sigma = self._params_values()
        d = self.distance_metric.diag(X)
        return self._profile(d, ls, sigma)


class SquaredExponential(_RadialKernel):
    """sigma^2 exp(-(d/l)^2)."""

    _length_scale_param = "squared_exponential_length_scale"
    _sigma_param = "sigma_squared_exponential"
    _profile_name = "squared_exponential"

    def __init__(self, length_scale=DEFAULT_LENGTH_SCALE, sigma=DEFAULT_RADIAL_SIGMA,
                 distance_metric=EuclideanDistance()):
        self._init_params(length_scale, sigma, distance_metric)

    def _profile(self, distance, length_scale, sigma):
        return squared_exponential_covariance(distance, length_scale, sigma)


class Exponential(_RadialKernel):
    """sigma^2 exp(-|d|/l)."""

    _length_scale_param = "exponential_length_scale"
    _sigma_param = "sigma_exponential"
    _profile_name = "exponential"

    def __init__(self, length_scale=DEFAULT_LENGTH_SCALE, sigma=DEFAULT_RADIAL_SIGMA,
                 distance_metric=EuclideanDistance()):
        self._init_params(length_scale, sigma, distance_metric)

    def _profile(self, distance, length_scale, sigma):
        return exponential_covariance(distance, length_scale, sigma)


class Matern32(_RadialKernel):
    """sigma^2 (1 + sqrt(3) d/l) exp(-sqrt(3) d/l)."""

    _length_scale_param = "matern_32_length_scale"
    _sigma_param = "sigma_matern_32"
    _profile_name = "matern_32"

    def __init__(self, length_scale=DEFAULT_LENGTH_SCALE, sigma=DEFAULT_RADIAL_SIGMA,
                 distance_metric=EuclideanDistance()):
        self._init_params(length_scale, sigma, distance_metric)

    def _profile(self, distance, length_scale, sigma):
        return matern_32_covariance(distance, length_scale, sigma)


class Matern52(_RadialKernel):
    """sigma^2 (1 + sqrt(5) d/l + 5 d^2 / 3 l^2) exp(-sqrt(5) d/l)."""

    _length_scale_param = "matern_52_length_scale"
    _sigma_param = "sigma_matern_52"
    _profile_name = "matern_52"

    def __init__(self, length_scale=DEFAULT_LENGTH_SCALE, sigma=DEFAULT_RADIAL_SIGMA,
                 distance_metric=EuclideanDistance()):
        self._init_params(length_scale, sigma, distance_metric)

    def _profile(self, distance, length_scale, sigma):
        return matern_52_covariance(distance, length_scale, sigma)
