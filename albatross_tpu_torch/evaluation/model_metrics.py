"""Model metrics: objective functions of (dataset, model).

Counterpart of ``albatross_tpu.evaluation.model_metrics``.  Each is
differentiable with respect to the model's parameter values, so the tuners
take any of them as an objective.  The cross-validated ones run the fast
LOO / LOGO of ``model.cross_validate()``.
"""

from __future__ import annotations

import torch

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution
from ..indexing.grouping import LeaveOneOutGrouper
from .metrics import NegativeLogLikelihood, RootMeanSquareError


class ModelMetric:
    """Callable (dataset, model) -> scalar."""

    def __call__(self, dataset: RegressionDataset, model):
        raise NotImplementedError


def _minus_prior(total: torch.Tensor, model) -> torch.Tensor:
    return total - model.prior_log_likelihood().to(device=total.device, dtype=total.dtype)


class LeaveOneOutLikelihood(ModelMetric):
    """The folds' summed negative log likelihood minus the prior
    log-likelihood."""

    def __init__(self, predict_type=JointDistribution):
        self.nll = NegativeLogLikelihood(predict_type)

    def __call__(self, dataset, model):
        scores = model.cross_validate().scores(self.nll, dataset, LeaveOneOutGrouper())
        return _minus_prior(torch.sum(scores), model)


class LeaveOneGroupOutLikelihood(ModelMetric):
    """The same over the groups of ``grouper``."""

    def __init__(self, grouper, predict_type=JointDistribution):
        self.grouper = grouper
        self.nll = NegativeLogLikelihood(predict_type)

    def __call__(self, dataset, model):
        scores = model.cross_validate().scores(self.nll, dataset, self.grouper)
        return _minus_prior(torch.sum(scores), model)


class LeaveOneOutRMSE(ModelMetric):
    """The mean of the folds' RMSE."""

    def __call__(self, dataset, model):
        scores = model.cross_validate().scores(RootMeanSquareError(), dataset, LeaveOneOutGrouper())
        return torch.mean(scores)


class GaussianProcessNegativeLogLikelihood(ModelMetric):
    """-model.log_likelihood(dataset): differentiable with respect to the
    model's parameter values."""

    def __call__(self, dataset, model):
        return -model.log_likelihood(dataset)
