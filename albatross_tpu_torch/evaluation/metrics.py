"""Prediction metrics.

Counterpart of part of ``albatross_tpu.evaluation.metrics``: a metric is a
callable ``metric(prediction, truth: MarginalDistribution) -> scalar`` that
declares the prediction type it needs (``required_predict_type``), so
cross-validation asks for the cheapest one.  Ported here: RMSE, the
residuals' standard deviation, the marginal and joint negative log
likelihood, the closed-form CRPS and the chi-squared CDF of the
Mahalanobis statistic.  ``energy_score``, ``variogram_score`` and
``wasserstein_2`` wait for a later slice.
"""

from __future__ import annotations

import math

import torch

from ..core.distributions import JointDistribution, MarginalDistribution
from ..ops.linalg import CholeskyFactor
from ..stats.chi_squared import chi_squared_cdf

LOG_2PI = math.log(2.0 * math.pi)


def _mean_vector(prediction):
    if isinstance(prediction, (MarginalDistribution, JointDistribution)):
        return prediction.mean
    return torch.as_tensor(prediction)


def _resolve(prediction, required_type):
    from ..models.base import Prediction  # lazy: models imports evaluation

    if isinstance(prediction, Prediction):
        return prediction.get(required_type)
    return prediction


class PredictionMetric:
    required_predict_type = None  # the mean vector

    def __call__(self, prediction, truth: MarginalDistribution):
        return self.evaluate(_resolve(prediction, self.required_predict_type), truth)

    def evaluate(self, prediction, truth):  # pragma: no cover - interface
        raise NotImplementedError


class RootMeanSquareError(PredictionMetric):
    """sqrt(mean((pred - y)^2))."""

    def evaluate(self, prediction, truth):
        error = _mean_vector(prediction) - truth.mean
        return torch.sqrt(torch.mean(error * error))


class StandardDeviation(PredictionMetric):
    """Sample standard deviation of the residuals (0 for one residual)."""

    def evaluate(self, prediction, truth):
        x = _mean_vector(prediction) - truth.mean
        n = x.shape[0]
        if n == 1:
            return x.new_zeros(())
        centered = x - torch.mean(x)
        return torch.sqrt(torch.sum(centered * centered) / (n - 1))


def negative_log_likelihood_marginal(prediction: MarginalDistribution, truth: MarginalDistribution):
    """Independent-Gaussian negative log likelihood."""
    deviation = prediction.mean - truth.mean
    variance = prediction.get_variance() + truth.get_variance()
    return 0.5 * torch.sum(torch.log(variance) + deviation * deviation / variance + LOG_2PI)


def negative_log_likelihood_joint(prediction: JointDistribution, truth: MarginalDistribution):
    """Dense multivariate-normal negative log likelihood."""
    deviation = prediction.mean - truth.mean
    chol = CholeskyFactor.factorize(prediction.covariance + torch.diag(truth.get_variance()))
    white = chol.sqrt_solve(deviation)
    return 0.5 * (chol.log_determinant() + torch.sum(white * white) + deviation.shape[0] * LOG_2PI)


class ChiSquaredCdf(PredictionMetric):
    """CDF of the Mahalanobis statistic of the deviation under chi^2(n)."""

    required_predict_type = JointDistribution

    def evaluate(self, prediction: JointDistribution, truth):
        covariance = prediction.covariance + torch.diag(truth.get_variance())
        return chi_squared_cdf(prediction.mean - truth.mean, covariance)


class NegativeLogLikelihood(PredictionMetric):
    def __init__(self, predict_type=MarginalDistribution):
        self.required_predict_type = predict_type

    def evaluate(self, prediction, truth):
        if isinstance(prediction, JointDistribution):
            return negative_log_likelihood_joint(prediction, truth)
        return negative_log_likelihood_marginal(prediction, truth)


def crps_normal(mu, sigma, y):
    """Closed-form CRPS of a univariate normal: non-finite inputs give NaN,
    sigma <= 0 degenerates to the absolute error.  Numbers that are not a
    float tensor are taken at f64."""
    if not (isinstance(mu, torch.Tensor) and mu.is_floating_point()):
        mu = torch.as_tensor(mu, dtype=torch.float64)
    sigma = torch.as_tensor(sigma, dtype=mu.dtype, device=mu.device)
    y = torch.as_tensor(y, dtype=mu.dtype, device=mu.device)
    safe_sigma = torch.where(sigma > 0.0, sigma, torch.ones_like(sigma))
    z = (y - mu) / safe_sigma
    erfz = torch.special.erf(z / math.sqrt(2.0))
    phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    crps = safe_sigma * (z * erfz + 2.0 * phi - 1.0 / math.sqrt(math.pi))
    out = torch.where(sigma <= 0.0, torch.abs(y - mu), crps)
    finite = torch.isfinite(mu) & torch.isfinite(sigma) & torch.isfinite(y)
    return torch.where(finite, out, torch.full_like(out, float("nan")))


class Crps(PredictionMetric):
    """Mean CRPS over the marginals."""

    required_predict_type = MarginalDistribution

    def evaluate(self, prediction: MarginalDistribution, truth):
        sigma = torch.sqrt(prediction.get_variance() + truth.get_variance())
        return torch.mean(crps_normal(prediction.mean, sigma, truth.mean))
