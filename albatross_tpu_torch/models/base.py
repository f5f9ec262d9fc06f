"""Model protocol: ModelBase, FitModel and the lazy Prediction.

Counterpart of ``albatross_tpu.models.base``: a model implements
``_fit_impl(features, targets)`` plus any of ``_predict_mean`` /
``_predict_marginal`` / ``_predict_joint``, and ``Prediction`` downgrades
joint -> marginal -> mean to the cheapest one the model offers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..core.dataset import RegressionDataset, feature_count
from ..core.distributions import JointDistribution, MarginalDistribution
from ..core.module import Module


class ModelBase(Module):
    def _fit_impl(self, features, targets: MarginalDistribution):
        raise NotImplementedError

    def fit(self, features, targets=None) -> "FitModel":
        if targets is None:
            if not isinstance(features, RegressionDataset):
                raise TypeError("fit() needs (features, targets) or a dataset")
            features, targets = features.features, features.targets
        elif not isinstance(targets, MarginalDistribution):
            targets = MarginalDistribution.create(targets)
        return FitModel(self, self._fit_impl(features, targets))

    def cross_validate(self):
        from ..evaluation.cross_validation import CrossValidation

        return CrossValidation(self)

    @property
    def model_name(self) -> str:
        return type(self).__name__.lower()


@dataclasses.dataclass(frozen=True)
class FitModel:
    """A model bound to its trained state."""

    model: ModelBase
    fit: Any

    def predict(self, features) -> "Prediction":
        return Prediction(self.model, self.fit, features)

    def get_fit(self):
        return self.fit


class Prediction:
    """Lazy prediction with joint -> marginal -> mean downgrade."""

    def __init__(self, model: ModelBase, fit: Any, features):
        self.model = model
        self.fit = fit
        self.features = features

    def mean(self):
        if hasattr(self.model, "_predict_mean"):
            return self.model._predict_mean(self.features, self.fit)
        return self.marginal().mean

    def marginal(self) -> MarginalDistribution:
        if hasattr(self.model, "_predict_marginal"):
            return self.model._predict_marginal(self.features, self.fit)
        return self.joint().marginal()

    def joint(self) -> JointDistribution:
        if not hasattr(self.model, "_predict_joint"):
            raise TypeError(f"{type(self.model).__name__} cannot produce joint predictions")
        return self.model._predict_joint(self.features, self.fit)

    def get(self, predict_type):
        if predict_type is MarginalDistribution:
            return self.marginal()
        if predict_type is JointDistribution:
            return self.joint()
        return self.mean()

    @property
    def size(self) -> int:
        return feature_count(self.features)
