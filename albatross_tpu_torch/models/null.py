"""NullModel: zero mean and a huge variance, a fallback and a baseline.

Counterpart of ``albatross_tpu.models.null``.  Predictions lie on the
features' device when the features are a tensor, and on the card otherwise
(``config.device(None)``); they take the features' dtype when it is a
floating-point one.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import config
from ..core.dataset import feature_count
from ..core.distributions import JointDistribution, MarginalDistribution
from ..kernels.features import LinearCombinationBatch, strip_measurement
from .base import FitModel, ModelBase

NULL_VARIANCE = 1e4


@dataclasses.dataclass(frozen=True)
class NullFit:
    pass


def _like(features) -> dict:
    raw, _ = strip_measurement(features)
    if isinstance(raw, LinearCombinationBatch):
        raw = raw.values
    if not isinstance(raw, torch.Tensor):
        return {"device": config.device(None)}
    if raw.is_floating_point():
        return {"dtype": raw.dtype, "device": raw.device}
    return {"device": raw.device}


class NullModel(ModelBase):
    @property
    def model_name(self):
        return "null_model"

    def _fit_impl(self, features, targets):
        return NullFit()

    def fit_from_prediction(self, features, prediction):
        return FitModel(self, NullFit())

    def _predict_marginal(self, features, fit):
        n = feature_count(features)
        return MarginalDistribution(torch.zeros(n, **_like(features)),
                                    torch.full((n,), NULL_VARIANCE, **_like(features)))

    def _predict_joint(self, features, fit):
        n = feature_count(features)
        return JointDistribution(torch.zeros(n, **_like(features)), NULL_VARIANCE * torch.eye(n, **_like(features)))
