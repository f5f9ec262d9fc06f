"""Exact Gaussian-process regression.

Counterpart of ``albatross_tpu.models.gp`` (main path):
* fit: wrap the training batch as Measurements, build the training
  covariance (gram + noise + target variance + jitter, in one gram-kernel
  pass when the kernel matches), subtract the mean, factorize, and keep the
  information vector v = K^-1 y;
* predict mean  : K*^T v;
* predict marg. : prior_diag - colsum(K^-1 K* o K*), with the clamp of
  rounding-scale negatives;
* predict joint : K** - K*^T K^-1 K*;
* log_likelihood: -NLL(y - m(X), K(X, X)) + sum of prior log-pdfs, with no
  target variance added, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution, MarginalDistribution
from ..core.parameters import map_join
from ..kernels.base import CovarianceFunction
from ..kernels.features import Measurement, as_measurement
from ..kernels.means import MeanFunction, ZeroMean
from ..ops.linalg import CholeskyFactor
from ..ops.radial_gram import fused_training_covariance
from .base import ModelBase

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class GPFit:
    """Trained GP state: features, factorized training covariance, and the
    information vector v = K^-1 y."""

    train_features: Any
    train_covariance: CholeskyFactor
    information: torch.Tensor


def gp_mean_prediction(cross_cov, information):
    return cross_cov.T @ information


def gp_marginal_prediction(cross_cov, prior_variance, information, train_covariance):
    pred = gp_mean_prediction(cross_cov, information)
    explained = train_covariance.solve(cross_cov)
    explained_variance = torch.sum(explained * cross_cov, dim=0)
    # In f32 the cancellation prior - explained can round a few ulps
    # negative next to training points; clamp only rounding-scale negatives
    # (window 1e-3 of the magnitudes: the solve's forward error is
    # kappa-amplified), so a failed factorization still surfaces.
    raw = prior_variance - explained_variance
    scale = torch.abs(prior_variance) + torch.abs(explained_variance)
    rounding_negative = raw >= -1e-3 * scale
    return MarginalDistribution(
        pred, torch.where(rounding_negative, torch.clamp_min(raw, 0.0), raw)
    )


def gp_joint_prediction(cross_cov, prior_cov, information, train_covariance):
    pred = gp_mean_prediction(cross_cov, information)
    explained_cov = cross_cov.T @ train_covariance.solve(cross_cov)
    return JointDistribution(pred, prior_cov - explained_cov)


def _nll_from_whitened(log_det, white):
    """1/2 (log|K| + ||L^-1 dev||^2 + n log 2 pi); no target variance."""
    n = white.shape[0]
    return 0.5 * (log_det + torch.sum(white * white) + n * LOG_2PI)


class GaussianProcess(ModelBase):
    """Exact GP regression model."""

    def __init__(
        self,
        covariance: CovarianceFunction,
        mean: Optional[MeanFunction] = None,
        model_name: Optional[str] = None,
        jitter: float = 0.0,
    ):
        self.covariance_function = covariance
        self.mean_function = mean if mean is not None else ZeroMean()
        self._model_name = model_name
        self.jitter = jitter

    @property
    def model_name(self) -> str:
        if self._model_name:
            return self._model_name
        return f"mean:{self.mean_function.name}cov:{self.covariance_function.name}"

    def get_params(self):
        return map_join(
            self.mean_function.get_params(), self.covariance_function.get_params()
        )

    def _training_covariance(self, measurements, target_variance):
        """(training covariance, jitter already included).  Kernels that
        match ``radial + diagonal-only noise`` get the whole covariance from
        one gram pass (ops/radial_gram.py fused_training_covariance)."""
        if isinstance(measurements, Measurement):
            fused = fused_training_covariance(
                self.covariance_function, measurements.value, target_variance, self.jitter
            )
            if fused is not None:
                return fused, True
        cov = self.covariance_function(measurements)
        if target_variance is not None:
            cov = cov + torch.diag(target_variance)
        return cov, False

    def _fit_impl(self, features, targets: MarginalDistribution) -> GPFit:
        measurements = as_measurement(features)
        cov, fused = self._training_covariance(measurements, targets.variance)
        zero_mean = self.mean_function.remove_from(measurements, targets.mean)
        chol = self._factorize(cov, jitter_applied=fused)
        return GPFit(features, chol, chol.solve(zero_mean))

    def _factorize(self, cov, jitter_applied: bool = False) -> CholeskyFactor:
        # covariances from the DSL are symmetric by construction
        jitter = 0.0 if jitter_applied else self.jitter
        return CholeskyFactor.factorize(cov, jitter=jitter, assume_symmetric=True)

    def _cross(self, fit: GPFit, features):
        return self.covariance_function.matrix_or_none(fit.train_features, features)

    def _predict_mean(self, features, fit: GPFit):
        pred = gp_mean_prediction(self._cross(fit, features), fit.information)
        return self.mean_function.add_to(features, pred)

    def _predict_marginal(self, features, fit: GPFit) -> MarginalDistribution:
        cross = self._cross(fit, features)
        prior_variance = self.covariance_function.diag(features)
        pred = gp_marginal_prediction(
            cross, prior_variance, fit.information, fit.train_covariance
        )
        return MarginalDistribution(
            self.mean_function.add_to(features, pred.mean), pred.variance
        )

    def _predict_joint(self, features, fit: GPFit) -> JointDistribution:
        cross = self._cross(fit, features)
        prior_cov = self.covariance_function(features)
        pred = gp_joint_prediction(cross, prior_cov, fit.information, fit.train_covariance)
        return JointDistribution(
            self.mean_function.add_to(features, pred.mean), pred.covariance
        )

    def log_likelihood(self, dataset: RegressionDataset) -> torch.Tensor:
        """Log marginal likelihood plus the parameters' prior log-pdfs.

        The covariance is materialized and factorized without assembling
        the factor (CholeskyFactor.nlml_terms)."""
        measurements = as_measurement(dataset.features)
        zero_mean = self.mean_function.remove_from(measurements, dataset.targets.mean)
        cov, fused = self._training_covariance(measurements, None)
        log_det, white = CholeskyFactor.nlml_terms(
            cov, zero_mean, jitter=0.0 if fused else self.jitter, assume_symmetric=True
        )
        ll = -_nll_from_whitened(log_det, white)
        return ll + self.prior_log_likelihood().to(device=ll.device, dtype=ll.dtype)


def gp_from_covariance(
    covariance: CovarianceFunction, model_name: Optional[str] = None, **kwargs
) -> GaussianProcess:
    return GaussianProcess(covariance, model_name=model_name, **kwargs)
