"""Model protocol: ModelBase, FitModel and the lazy Prediction.

Counterpart of ``albatross_tpu.models.base``: a model implements
``_fit_impl(features, targets)`` plus any of ``_predict_mean`` /
``_predict_marginal`` / ``_predict_joint``, and ``Prediction`` downgrades
joint -> marginal -> mean to the cheapest one the model offers.  A model
that implements ``_update_impl(fit, features, targets)`` takes online
updates through ``FitModel.update``.
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

    def fit_from_prediction(self, features, prediction: JointDistribution):
        raise NotImplementedError(f"{type(self).__name__} does not support fit_from_prediction")

    def cross_validate(self):
        from ..evaluation.cross_validation import CrossValidation

        return CrossValidation(self)

    def ransac(self, strategy, config, **kwargs):
        from .ransac import Ransac

        return Ransac(self, strategy, config, **kwargs)

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

    def predict_with_measurement_noise(self, features) -> "Prediction":
        """Predict at ``features`` as measurements: measurement-only terms
        (observation noise) count in the predicted covariance."""
        from ..kernels.features import as_measurement

        return Prediction(self.model, self.fit, as_measurement(features))

    def update(self, features, targets=None) -> "FitModel":
        """Online update with new observations: (features, targets) or a
        dataset."""
        if targets is None and isinstance(features, RegressionDataset):
            features, targets = features.features, features.targets
        if not isinstance(targets, MarginalDistribution):
            targets = MarginalDistribution.create(targets)
        return FitModel(self.model, self.model._update_impl(self.fit, features, targets))

    def get_fit(self):
        return self.fit

    def for_serving(self) -> "FitModel":
        """The fit with its factorization swapped for an explicit inverse
        (``CholeskyFactor.to_direct_inverse``): predictions solve by one
        product, at the cost of one O(N^3) inversion up front.  A fit whose
        training covariance has no explicit-inverse form (a sparse fit, or
        an exact fit after ``update``) comes back unchanged."""
        from .gp import GPFit

        cov = getattr(self.fit, "train_covariance", None)
        if not isinstance(self.fit, GPFit) or not hasattr(cov, "to_direct_inverse"):
            return self
        return FitModel(self.model, dataclasses.replace(self.fit, train_covariance=cov.to_direct_inverse()))


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
