"""Adapted models: a feature conversion in front of any model.

Counterpart of ``albatross_tpu.models.adapter``: ``convert(adapter,
features)`` runs before every fit, predict and log-likelihood of
``sub_model``, and may read the adapter's own parameters, which are
ordinary Module attributes (so the get/set and tunable-vector machinery,
and autograd through it, apply).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..core.dataset import RegressionDataset
from ..core.parameters import Parameter
from .base import ModelBase


class AdaptedModel(ModelBase):
    """Wraps ``sub_model``, converting features first."""

    def __init__(self, sub_model: ModelBase, convert: Callable, params: Optional[Dict[str, Parameter]] = None):
        self.sub_model = sub_model
        self.convert = convert
        for name, p in (params or {}).items():
            setattr(self, name, p)

    @property
    def model_name(self):
        return f"adapted[{self.sub_model.model_name}]"

    def _fit_impl(self, features, targets):
        return self.sub_model._fit_impl(self.convert(self, features), targets)

    def _predict_mean(self, features, fit):
        return self.sub_model._predict_mean(self.convert(self, features), fit)

    def _predict_marginal(self, features, fit):
        return self.sub_model._predict_marginal(self.convert(self, features), fit)

    def _predict_joint(self, features, fit):
        return self.sub_model._predict_joint(self.convert(self, features), fit)

    def log_likelihood(self, dataset: RegressionDataset):
        converted = RegressionDataset(self.convert(self, dataset.features), dataset.targets, dict(dataset.metadata))
        return self.sub_model.log_likelihood(converted)
