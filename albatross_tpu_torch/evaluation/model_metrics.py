"""Model metrics: objective functions of (dataset, model).

Counterpart of the negative-log-likelihood part of
``albatross_tpu.evaluation.model_metrics``; the cross-validated metrics
(leave-one-out, leave-one-group-out) come with the port of
``evaluation/`` cross-validation.
"""

from __future__ import annotations

from ..core.dataset import RegressionDataset


class ModelMetric:
    """Callable (dataset, model) -> scalar."""

    def __call__(self, dataset: RegressionDataset, model):
        raise NotImplementedError


class GaussianProcessNegativeLogLikelihood(ModelMetric):
    """-model.log_likelihood(dataset): differentiable with respect to the
    model's parameter values."""

    def __call__(self, dataset, model):
        return -model.log_likelihood(dataset)
