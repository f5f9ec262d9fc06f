"""Cross-validation entry point.

Counterpart of ``albatross_tpu.evaluation.cross_validation``:
``model.cross_validate().predict(dataset, grouper)`` gives a CV prediction
whose ``means() / marginals() / joints()`` use the model's fast
``cross_validated_predictions`` (one factorization and the inverse's
diagonal blocks for a GP) where it has one, else a fit and a predict per
fold.
"""

from __future__ import annotations

from typing import Type

import numpy as np
import torch

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution, MarginalDistribution
from ..indexing.grouping import Grouped, group_by
from ..utils.profiling import named_scope
from .cross_validation_utils import BatchedGrouped, batched_cross_validated_scores, cross_validated_scores
from .folds import folds_from_group_indexer


def predict_fold(model, fold):
    """Fit on the fold's train set, predict its test set."""
    return model.fit(fold.train_dataset).predict(fold.test_dataset.features)


class CVPrediction:
    """Grouped cross-validated predictions, computed on request."""

    def __init__(self, model, dataset: RegressionDataset, indexers: Grouped):
        self.model = model
        self.dataset = dataset
        self.indexers = indexers

    def _folds(self) -> Grouped:
        return folds_from_group_indexer(self.dataset, self.indexers)

    def predictions(self) -> Grouped:
        return self._folds().apply(lambda fold: predict_fold(self.model, fold))

    def _grouped(self, predict_type: Type) -> Grouped:
        if hasattr(self.model, "cross_validated_predictions"):
            return self.model.cross_validated_predictions(self.dataset, self.indexers, predict_type)
        return self.predictions().apply(lambda p: p.get(predict_type))

    def means(self) -> Grouped:
        return self._grouped(None)

    def marginals(self) -> Grouped:
        return self._grouped(MarginalDistribution)

    def joints(self) -> Grouped:
        return self._grouped(JointDistribution)

    def get(self, predict_type: Type) -> Grouped:
        return self._grouped(predict_type)

    # -- views concatenated back into the dataset's order ------------------
    def _scatter_flat(self, flat_mean, flat_var=None):
        order = torch.as_tensor(np.concatenate(self.indexers.values()), device=flat_mean.device)
        mean = flat_mean.new_zeros(self.dataset.size).index_copy(0, order, flat_mean)
        if flat_var is None:
            return mean
        return mean, flat_var.new_zeros(self.dataset.size).index_copy(0, order, flat_var)

    def mean(self) -> torch.Tensor:
        """Held-out means in the dataset's order."""
        means = self.means()
        if isinstance(means, BatchedGrouped):
            return self._scatter_flat(means.means.reshape(-1))
        return self._scatter_flat(torch.cat([torch.atleast_1d(m) for m in means.values()]))

    def marginal(self) -> MarginalDistribution:
        marginals = self.marginals()
        if isinstance(marginals, BatchedGrouped):
            flat = marginals.means.reshape(-1), marginals.variances.reshape(-1)
        else:
            flat = (torch.cat([torch.atleast_1d(m.mean) for m in marginals.values()]),
                    torch.cat([torch.atleast_1d(m.get_variance()) for m in marginals.values()]))
        return MarginalDistribution(*self._scatter_flat(*flat))


class CrossValidation:
    """What ``model.cross_validate()`` returns."""

    def __init__(self, model):
        self.model = model

    @named_scope("albatross.cv.folds")
    def _indexers(self, dataset, grouper) -> Grouped:
        if isinstance(grouper, Grouped):
            return grouper
        return group_by(dataset, grouper).indexers()

    def predict(self, dataset: RegressionDataset, grouper) -> CVPrediction:
        return CVPrediction(self.model, dataset, self._indexers(dataset, grouper))

    def scores(self, metric, dataset: RegressionDataset, grouper) -> torch.Tensor:
        """Each fold's metric, in sorted key order."""
        indexers = self._indexers(dataset, grouper)
        predictions = CVPrediction(self.model, dataset, indexers).get(
            getattr(metric, "required_predict_type", None))
        with named_scope("albatross.cv.scores"):
            if isinstance(predictions, BatchedGrouped):
                out = batched_cross_validated_scores(metric, dataset, indexers, predictions)
                if out is not None:
                    return out
            return cross_validated_scores(metric, folds_from_group_indexer(dataset, indexers), predictions)
