"""Radial covariance kernels.

Counterpart of ``albatross_tpu.kernels.radial``: the same parameter names,
defaults, priors, closed forms and length-scale back-solvers.  A Euclidean
gram goes through ``ops.radial_gram.radial_gram`` -- the hand-written CUDA
kernel for CUDA tensors, the closed form for CPU tensors; any other metric
takes the profile of its ``pairwise`` distances in torch ops, as the JAX
package computes those with XLA ops outside its Pallas kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.parameters import Parameter, host_float
from ..core.priors import NonNegativePrior, PositivePrior
from .base import CovarianceFunction
from .distances import AngularDistance, DistanceMetric, EuclideanDistance, RadialDistance

DEFAULT_LENGTH_SCALE = 100000.0
DEFAULT_RADIAL_SIGMA = 10.0

MAX_NEWTON_ITERATIONS = 50
MAX_LENGTH_SCALE_RATIO = 1e7
MIN_LENGTH_SCALE_RATIO = 1e-7


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
    """Shared machinery: distance -> profile, the diagonal, 1-D inducing
    grids."""

    _length_scale_param: str
    _sigma_param: str
    _profile_name: str
    # profiles that are not positive definite on a sphere (Gneiting)
    _angular_not_psd = False

    def _init_params(self, length_scale, sigma, distance_metric):
        if self._angular_not_psd and isinstance(distance_metric, AngularDistance):
            raise TypeError(f"{type(self).__name__} covariance with AngularDistance is not PSD.")
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
        if not isinstance(self.distance_metric, EuclideanDistance):
            return self._profile(self.distance_metric.pairwise(X, Y), ls, sigma)
        if host_float(ls) <= 0.0:
            return torch.zeros((X.shape[0], Y.shape[0]), dtype=X.dtype, device=X.device)
        return radial_gram(X, Y, ls, sigma, self._profile_name)

    def _symmetric_exact(self, X):
        """Euclidean grams of X against itself are bitwise symmetric: below
        D = 8 (and in f64, and on the CPU) as exact elementwise sums; in
        the kernel's f32 tensor-core branch at D >= 8, whose contraction is
        not transpose-exact, because a call with one tensor on both sides
        (``__call__`` and ``matrix_or_none(X, X)``, the fused training
        covariance, the lazy loop's column blocks) computes the tiles
        I >= J of K(X, X) and writes each twice (its mirror), and
        ``tagged_gram`` takes a batch's block (b, a) against itself as the
        transpose of (a, b).  The claim covers those callers only: the
        sharded grams of ``parallel/`` build a rank's rows by the cross
        form on two distinct batches, symmetric at D >= 8 only to the
        contraction's rounding (their factorizations read the lower block
        triangle).  Radial distances are norm differences; the angular
        metric's and a user metric's products are not transpose-exact, so
        __call__ symmetrizes them."""
        return isinstance(self.distance_metric, (EuclideanDistance, RadialDistance))

    def _diag(self, X, x_meas):
        ls, sigma = self._params_values()
        d = self.distance_metric.diag(X)
        return self._profile(d, ls, sigma)

    def state_space_representation(self, X):
        """Uniform 1-D grid over the range of X with about
        ``_ssr_points_per_length_scale`` points per length scale (at least
        3), in X's dtype and on its device.  X and the length scale are read
        on the host: the grid's size depends on them."""
        ls, _ = self._params_values()
        x = X.detach().reshape(-1).cpu()
        lo, hi = float(x.min()), float(x.max())
        n = max(3, int(math.ceil(self._ssr_points_per_length_scale * (hi - lo) / host_float(ls))))
        return torch.linspace(lo, hi, n, dtype=X.dtype, device=X.device)


class SquaredExponential(_RadialKernel):
    """sigma^2 exp(-(d/l)^2)."""

    _length_scale_param = "squared_exponential_length_scale"
    _sigma_param = "sigma_squared_exponential"
    _profile_name = "squared_exponential"
    _ssr_points_per_length_scale = 10.0
    _angular_not_psd = True

    def __init__(self, length_scale=DEFAULT_LENGTH_SCALE, sigma=DEFAULT_RADIAL_SIGMA,
                 distance_metric: DistanceMetric = EuclideanDistance()):
        self._init_params(length_scale, sigma, distance_metric)

    def _profile(self, distance, length_scale, sigma):
        return squared_exponential_covariance(distance, length_scale, sigma)

    def derive_length_scale(self, reference_distance, sigma, std_dev_increase):
        return derive_squared_exponential_length_scale(reference_distance, sigma, std_dev_increase)


class Exponential(_RadialKernel):
    """sigma^2 exp(-|d|/l)."""

    _length_scale_param = "exponential_length_scale"
    _sigma_param = "sigma_exponential"
    _profile_name = "exponential"
    _ssr_points_per_length_scale = 20.0

    def __init__(self, length_scale=DEFAULT_LENGTH_SCALE, sigma=DEFAULT_RADIAL_SIGMA,
                 distance_metric: DistanceMetric = EuclideanDistance()):
        self._init_params(length_scale, sigma, distance_metric)

    def _profile(self, distance, length_scale, sigma):
        return exponential_covariance(distance, length_scale, sigma)

    def derive_length_scale(self, reference_distance, sigma, std_dev_increase):
        return derive_exponential_length_scale(reference_distance, sigma, std_dev_increase)


class Matern32(_RadialKernel):
    """sigma^2 (1 + sqrt(3) d/l) exp(-sqrt(3) d/l)."""

    _length_scale_param = "matern_32_length_scale"
    _sigma_param = "sigma_matern_32"
    _profile_name = "matern_32"
    _angular_not_psd = True

    def __init__(self, length_scale=DEFAULT_LENGTH_SCALE, sigma=DEFAULT_RADIAL_SIGMA,
                 distance_metric: DistanceMetric = EuclideanDistance()):
        self._init_params(length_scale, sigma, distance_metric)

    def _profile(self, distance, length_scale, sigma):
        return matern_32_covariance(distance, length_scale, sigma)

    def state_space_representation(self, X):
        return None

    def derive_length_scale(self, reference_distance, sigma, std_dev_increase):
        def grad(ratio):
            e = math.exp(-math.sqrt(3) / ratio)
            return (math.sqrt(3) * (1 + math.sqrt(3) / ratio) * e / ratio**2
                    - math.sqrt(3) * e / ratio**2)

        return _derive_length_scale_newton(reference_distance, sigma, std_dev_increase,
                                           _unit_profile(matern_32_covariance), grad)


class Matern52(_RadialKernel):
    """sigma^2 (1 + sqrt(5) d/l + 5 d^2 / 3 l^2) exp(-sqrt(5) d/l)."""

    _length_scale_param = "matern_52_length_scale"
    _sigma_param = "sigma_matern_52"
    _profile_name = "matern_52"
    _angular_not_psd = True

    def __init__(self, length_scale=DEFAULT_LENGTH_SCALE, sigma=DEFAULT_RADIAL_SIGMA,
                 distance_metric: DistanceMetric = EuclideanDistance()):
        self._init_params(length_scale, sigma, distance_metric)

    def _profile(self, distance, length_scale, sigma):
        return matern_52_covariance(distance, length_scale, sigma)

    def state_space_representation(self, X):
        return None

    def derive_length_scale(self, reference_distance, sigma, std_dev_increase):
        def grad(ratio):
            e = math.exp(-math.sqrt(5) / ratio)
            return ((-math.sqrt(5) / ratio**2 - 10.0 / 3.0 / ratio**3) * e
                    + math.sqrt(5) * (1 + math.sqrt(5) / ratio + 10.0 / 6.0 / ratio**2) * e / ratio**2)

        return _derive_length_scale_newton(reference_distance, sigma, std_dev_increase,
                                           _unit_profile(matern_52_covariance), grad)


# ---------------------------------------------------------------------------
# Decorrelation distance -> length scale back-solvers: host float math at
# model-configuration time, not in the compute path.
# ---------------------------------------------------------------------------
def _unit_profile(covariance):
    """ratio -> covariance(1, ratio, 1) as a host float, evaluated in f64."""
    one = torch.ones((), dtype=torch.float64)
    return lambda ratio: float(covariance(one, ratio, 1.0))


def process_noise_equivalent(func, distance: float) -> float:
    """STD[f_d | f_0] = sqrt(k(0) - k(d)^2 / k(0))."""
    k0 = func(0.0)
    kd = func(distance)
    return math.sqrt(k0 - kd * kd / k0)


def _valid_args(reference_distance, prior_sigma, std_dev_increase) -> bool:
    if not reference_distance > 0.0:
        raise ValueError(f"reference_distance must be positive, got {reference_distance}")
    return 0.0 < std_dev_increase < prior_sigma and prior_sigma > 0.0


def _fallback_length_scale(reference_distance, prior_sigma, std_dev_increase):
    if std_dev_increase <= 0.0 or prior_sigma <= 0.0:
        return MAX_LENGTH_SCALE_RATIO * reference_distance
    # otherwise std_dev_increase >= prior_sigma
    return MIN_LENGTH_SCALE_RATIO * reference_distance


def derive_squared_exponential_length_scale(reference_distance, prior_sigma, std_dev_increase):
    """Closed form."""
    if not _valid_args(reference_distance, prior_sigma, std_dev_increase):
        return _fallback_length_scale(reference_distance, prior_sigma, std_dev_increase)
    ratio = std_dev_increase / prior_sigma
    return math.sqrt(2.0) * reference_distance / math.sqrt(-math.log(1.0 - ratio**2))


def derive_exponential_length_scale(reference_distance, prior_sigma, std_dev_increase):
    """Closed form."""
    if not _valid_args(reference_distance, prior_sigma, std_dev_increase):
        return _fallback_length_scale(reference_distance, prior_sigma, std_dev_increase)
    ratio = std_dev_increase / prior_sigma
    return -2.0 * reference_distance / math.log(1.0 - ratio**2)


def _newton_solve(guess, target, func, grad, lower, upper, tolerance=1e-12):
    """Bounded scalar Newton iteration."""
    for _ in range(MAX_NEWTON_ITERATIONS):
        error = target - func(guess)
        if not math.isfinite(error):
            break
        # IEEE division (C++ semantics): error / 0 -> +-inf, which the
        # bounded step below turns into a bisection toward the bound
        with np.errstate(divide="ignore", invalid="ignore"):
            delta = float(np.float64(error) / np.float64(grad(guess)))
        if abs(error) < tolerance:
            break
        if guess - delta <= lower:
            guess = 0.5 * (guess + lower)
        elif guess - delta >= upper:
            guess = 0.5 * (guess + upper)
        else:
            guess -= delta
        guess = min(upper, max(lower, guess))
    return guess


def _derive_length_scale_newton(reference_distance, prior_sigma, std_dev_increase, func, grad):
    """Newton back-solve in log space, between the length-scale ratios
    MIN_LENGTH_SCALE_RATIO and MAX_LENGTH_SCALE_RATIO."""
    if not _valid_args(reference_distance, prior_sigma, std_dev_increase):
        return _fallback_length_scale(reference_distance, prior_sigma, std_dev_increase)

    def log_f(ratio):
        cov = func(ratio)
        if cov * cov >= 1.0:
            return math.log(1e-16)
        return math.log(prior_sigma) + 0.5 * math.log(1.0 - cov * cov)

    def log_g(ratio):
        cov = func(ratio)
        return grad(ratio) * cov / (1.0 - cov * cov)

    log_target = math.log(std_dev_increase)
    max_increase = log_f(MIN_LENGTH_SCALE_RATIO)
    if max_increase <= log_target:
        return MIN_LENGTH_SCALE_RATIO * reference_distance
    min_increase = log_f(MAX_LENGTH_SCALE_RATIO)
    if min_increase >= log_target:
        return MAX_LENGTH_SCALE_RATIO * reference_distance

    alpha = (max_increase - log_target) / (max_increase - min_increase)
    guess = math.exp(math.log(MIN_LENGTH_SCALE_RATIO)
                     + alpha * (math.log(MAX_LENGTH_SCALE_RATIO) - math.log(MIN_LENGTH_SCALE_RATIO)))
    solution = _newton_solve(guess, log_target, log_f, log_g, MIN_LENGTH_SCALE_RATIO, MAX_LENGTH_SCALE_RATIO)
    return solution * reference_distance
