"""Prediction metrics.

Counterpart of part of ``albatross_tpu.evaluation.metrics``: a metric is a
callable ``metric(prediction, truth: MarginalDistribution) -> scalar`` that
declares the prediction type it needs (``required_predict_type``), so
cross-validation asks for the cheapest one.  Ported here: RMSE, the
residuals' standard deviation, the marginal and joint negative log
likelihood, the closed-form CRPS and the chi-squared CDF of the
Mahalanobis statistic; and the multivariate scores: the energy score (a
Monte Carlo estimate from antithetic draws of a ``torch.Generator``), the
variogram score (closed form for p in {1, 2}) and the 2-Wasserstein
(Bures) distance between Gaussians.
"""

from __future__ import annotations

import math

import torch

from ..core.distributions import JointDistribution, MarginalDistribution
from ..ops.linalg import CholeskyFactor
from ..stats.chi_squared import chi_squared_cdf

LOG_2PI = math.log(2.0 * math.pi)

ENERGY_SCORE_DEFAULT_SAMPLES = 1000
ENERGY_SCORE_DEFAULT_SEED = 22


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


def _sampling_sqrt(covariance, rel_tol: float = 1.0e-8):
    """PSD square root for MVN sampling: an eigendecomposition, so singular
    but semidefinite covariances (GP posterior joints) sample, with
    rounding-scale negative eigenvalues clamped at zero; grossly indefinite
    input raises, as the reference's LDLT sampler asserts."""
    covariance = 0.5 * (covariance + covariance.T)
    vals, vecs = torch.linalg.eigh(covariance)
    scale = max(float(torch.max(torch.abs(vals))), 1.0)
    if float(torch.min(vals)) < -rel_tol * scale:
        raise ValueError("Please pass a positive definite covariance!")
    return vecs * torch.sqrt(torch.clamp_min(vals, 0.0))[None, :]


def _draw_mvn_antithetic(generator: torch.Generator, mean, sqrt_cov, num_samples: int, normals=None):
    """num_samples // 2 + 1 draws mean + S v and their mirrors mean - S v
    (variance reduction without bias); ``normals`` (n, num_samples // 2 + 1)
    replaces the draw of v."""
    k_generate = num_samples // 2 + 1
    if normals is None:
        normals = torch.randn((sqrt_cov.shape[0], k_generate), generator=generator, dtype=mean.dtype)
    half = mean[:, None] + sqrt_cov @ normals.to(device=mean.device, dtype=mean.dtype)
    return torch.cat([half, 2.0 * mean[:, None] - half], dim=1)


def energy_score(prediction: JointDistribution, truth, weights=None, seed: int = ENERGY_SCORE_DEFAULT_SEED,
                 num_samples: int = ENERGY_SCORE_DEFAULT_SAMPLES, normals=None):
    """ES(F, y) = E||X - y|| - 1/2 E||X - X'|| by paired antithetic Monte
    Carlo from a ``torch.Generator`` seeded with ``seed`` (so its value
    differs from the JAX package's by Monte Carlo error only);
    ``normals`` (two (n, num_samples // 2 + 1) arrays) replaces the draws.

    Per-dimension ``weights`` keep the reference's asymmetry: the mean-error
    term weights the squared errors (sqrt(sum w_i e_i^2)), the pairwise
    term the errors (sqrt(sum w_i^2 e_i^2)); uniform weights match no
    weights either way."""
    if num_samples <= 1:
        raise ValueError("Cannot form an MC approximation with 1 or fewer samples")
    n = int(prediction.mean.shape[0])
    truth_mean = truth.mean if isinstance(truth, MarginalDistribution) else torch.as_tensor(truth)
    if n != int(truth_mean.shape[0]):
        raise ValueError("Predictive distribution and truth have different sizes!")
    if weights is not None and tuple(torch.as_tensor(weights).shape) != (n,):
        raise ValueError("Energy score weights must be a vector matched to the size of the problem!")
    covariance = prediction.covariance
    if isinstance(truth, MarginalDistribution):
        covariance = covariance + torch.diag(truth.get_variance())
    mean = prediction.mean
    truth_mean = truth_mean.to(device=mean.device, dtype=mean.dtype)
    w = torch.ones_like(truth_mean) if weights is None else torch.as_tensor(
        weights, dtype=mean.dtype, device=mean.device)
    S = _sampling_sqrt(covariance)
    generator = torch.Generator(device="cpu").manual_seed(int(seed))
    samples_a, samples_b = (
        _draw_mvn_antithetic(generator, mean, S, num_samples, None if normals is None else normals[i])
        for i in range(2)
    )

    def mean_err_norm(samples):
        sq = (samples - truth_mean[:, None]) ** 2 * w[:, None]
        return torch.mean(torch.sqrt(torch.sum(sq, dim=0)))

    pairwise = torch.mean(torch.linalg.vector_norm((samples_a - samples_b) * w[:, None], dim=0))
    es = 0.5 * (mean_err_norm(samples_a) + mean_err_norm(samples_b)) - 0.5 * pairwise
    return torch.clamp_min(es, 0.0)


def expected_abs_normal_1(mu, sigma):
    """E|N(mu, sigma^2)|: non-finite inputs give NaN, sigma <= 0 the point
    mass |mu|.  Numbers that are not a float tensor are taken at f64."""
    if not (isinstance(mu, torch.Tensor) and mu.is_floating_point()):
        mu = torch.as_tensor(mu, dtype=torch.float64)
    sigma = torch.as_tensor(sigma, dtype=mu.dtype, device=mu.device)
    normalized = torch.abs(mu) / torch.clamp_min(sigma, 1e-16)
    val = sigma * math.sqrt(2.0 / math.pi) * torch.exp(-0.5 * normalized * normalized) + torch.abs(
        mu) * torch.special.erf(normalized / math.sqrt(2.0))
    out = torch.where(sigma <= 0.0, torch.abs(mu), val)
    finite = torch.isfinite(mu) & torch.isfinite(sigma)
    return torch.where(finite, out, torch.full_like(out, float("nan")))


def expected_abs_normal_2(mu, sigma):
    """E[N(mu, sigma^2)^2] = mu^2 + sigma^2."""
    return mu * mu + sigma * sigma


def variogram_score(prediction: JointDistribution, truth, weights=None, p: float = 1.0):
    """VS_p(F, y) = sum_{i<j} w_ij (|y_i - y_j|^p - E|X_i - X_j|^p)^2 in
    closed form for p = 1 (madogram, the default) and p = 2 (variogram); a
    MarginalDistribution truth adds its variance to the prediction's
    covariance."""
    cov = prediction.covariance
    if isinstance(truth, MarginalDistribution):
        truth_mean = truth.mean
        cov = cov + torch.diag(truth.get_variance())
    else:
        truth_mean = torch.as_tensor(truth)
    n = int(prediction.mean.shape[0])
    if int(truth_mean.shape[0]) != n:
        raise ValueError("Predictive distribution and truth have different sizes!")
    if weights is not None and tuple(torch.as_tensor(weights).shape) != (n, n):
        raise ValueError("Variogram score weights must be a square matrix matched to the size of the problem!")
    mu = prediction.mean
    truth_mean = truth_mean.to(device=mu.device, dtype=mu.dtype)
    d_mu = mu[:, None] - mu[None, :]
    d_var = torch.diagonal(cov)[:, None] + torch.diagonal(cov)[None, :] - 2.0 * cov
    d_sigma = torch.sqrt(torch.clamp_min(d_var, 0.0))
    if p == 2.0:
        expected = d_mu * d_mu + d_sigma * d_sigma
    elif p == 1.0:
        expected = expected_abs_normal_1(d_mu, d_sigma)
    else:
        raise ValueError("variogram_score supports p in {1, 2}")
    d_truth = torch.abs(truth_mean[:, None] - truth_mean[None, :]) ** p
    w = torch.ones_like(expected) if weights is None else torch.as_tensor(weights, dtype=mu.dtype,
                                                                          device=mu.device)
    return torch.sum(torch.triu(w * (d_truth - expected) ** 2, diagonal=1))


def _principal_sqrt(A):
    """Symmetric PSD square root, negative eigenvalues clamped at zero."""
    vals, vecs = torch.linalg.eigh(0.5 * (A + A.T))
    return (vecs * torch.sqrt(torch.clamp_min(vals, 0.0))[None, :]) @ vecs.T


def wasserstein_2(a: JointDistribution, b: JointDistribution):
    """Squared 2-Wasserstein (Bures) distance between two Gaussians."""
    b_sqrt = _principal_sqrt(b.covariance)
    cross = _principal_sqrt(b_sqrt @ a.covariance @ b_sqrt)
    mean_term = torch.sum((a.mean - b.mean) ** 2)
    return mean_term + torch.trace(a.covariance + b.covariance - 2.0 * cross)
