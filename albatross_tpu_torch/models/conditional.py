"""ConditionalGaussian: a model over index sets of a fixed (prior, truth).

Counterpart of ``albatross_tpu.models.conditional``: fit conditions on the
truth at a set of indices, predict gives the conditional at other indices.
The prior covariance is computed once; each fit is a small dense
factorization over its indices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.distributions import JointDistribution, MarginalDistribution, as_index
from ..ops.linalg import CholeskyFactor
from .base import FitModel, ModelBase
from .gp import gp_joint_prediction, gp_marginal_prediction, gp_mean_prediction


@dataclasses.dataclass(frozen=True)
class ConditionalFit:
    information: torch.Tensor
    cov_chol: CholeskyFactor
    indices: torch.Tensor


class ConditionalGaussian(ModelBase):
    def __init__(self, prior: JointDistribution, truth: MarginalDistribution):
        self.prior = prior
        self.truth = truth

    @property
    def model_name(self):
        return "conditional_gaussian"

    def _index(self, indices) -> torch.Tensor:
        return as_index(indices, self.prior.mean.device)

    def fit_from_indices(self, indices) -> ConditionalFit:
        indices = self._index(indices)
        train_prior = self.prior.subset(indices)
        train_truth = self.truth.subset(indices)
        deviation = train_truth.mean - train_prior.mean
        chol = CholeskyFactor.factorize(train_prior.covariance + torch.diag(train_truth.get_variance()))
        return ConditionalFit(chol.solve(deviation), chol, indices)

    def fit(self, indices, targets=None) -> FitModel:
        return FitModel(self, self.fit_from_indices(indices))

    def get_prior(self, indices) -> JointDistribution:
        return self.prior.subset(self._index(indices))

    def get_truth(self, indices) -> MarginalDistribution:
        return self.truth.subset(self._index(indices))

    def _cross(self, fit: ConditionalFit, predict_indices: torch.Tensor):
        return self.prior.covariance[fit.indices[:, None], predict_indices[None, :]]

    def _predict_mean(self, predict_indices, fit: ConditionalFit):
        idx = self._index(predict_indices)
        return gp_mean_prediction(self._cross(fit, idx), fit.information) + self.prior.mean[idx]

    def _predict_marginal(self, predict_indices, fit: ConditionalFit):
        idx = self._index(predict_indices)
        prior_var = torch.diagonal(self.prior.covariance)[idx]
        pred = gp_marginal_prediction(self._cross(fit, idx), prior_var, fit.information, fit.cov_chol)
        return MarginalDistribution(pred.mean + self.prior.mean[idx], pred.variance)

    def _predict_joint(self, predict_indices, fit: ConditionalFit):
        idx = self._index(predict_indices)
        prior_cov = self.prior.covariance[idx[:, None], idx[None, :]]
        pred = gp_joint_prediction(self._cross(fit, idx), prior_cov, fit.information, fit.cov_chol)
        return JointDistribution(pred.mean + self.prior.mean[idx], pred.covariance)
