"""Feature wrappers: Measurement tags and linear combinations.

Counterpart of ``albatross_tpu.kernels.features``: a ``Measurement`` tags a
whole feature batch as noisy observations (the GP fit wraps its training
set exactly once); a ``LinearCombinationBatch`` holds N combinations of K
base features, which a covariance evaluates as one gram over the N * K
flattened features contracted with the coefficients
(``CovarianceFunction._linear_combination_matrix``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Tags a feature batch as noisy measurements."""

    value: Any


@dataclasses.dataclass(frozen=True)
class LinearCombinationBatch:
    """N combinations of K base features: ``values`` of shape (N, K, ...),
    ``coefficients`` of shape (N, K)."""

    values: Any
    coefficients: Any

    @property
    def size(self) -> int:
        return self.coefficients.shape[0]

    @property
    def combo_size(self) -> int:
        return self.coefficients.shape[1]

    def flat_values(self) -> torch.Tensor:
        """The (N, K) leading axes merged: (N * K, ...)."""
        return self.values.reshape((-1,) + tuple(self.values.shape[2:]))


def as_measurement(features) -> Measurement:
    if isinstance(features, Measurement):
        return features
    return Measurement(features)


# the reference's vector form; on batches the two are the same
as_measurements = as_measurement


def strip_measurement(features):
    """Unwrap, returning (raw_features, was_measurement)."""
    if isinstance(features, Measurement):
        return features.value, True
    return features, False


def _coefficients_like(features: torch.Tensor, values) -> torch.Tensor:
    """Coefficients on the features' device, in their dtype when it is a
    float type (else the default float dtype)."""
    dtype = features.dtype if features.is_floating_point() else torch.get_default_dtype()
    return torch.as_tensor(values, dtype=dtype, device=features.device)


def to_linear_combination(features, coefficients=None) -> LinearCombinationBatch:
    """One combination spanning the given K features (all coefficients 1
    unless given); an existing combination comes back unchanged."""
    if isinstance(features, LinearCombinationBatch):
        if coefficients is not None:
            raise ValueError("cannot re-weight an existing LinearCombinationBatch")
        return features
    k = features.shape[0]
    coefficients = _coefficients_like(features, [1.0] * k if coefficients is None else coefficients)
    return LinearCombinationBatch(features[None], coefficients[None, :])


def sum_of(features) -> LinearCombinationBatch:
    return to_linear_combination(features)


def mean_of(features) -> LinearCombinationBatch:
    k = features.shape[0]
    return to_linear_combination(features, [1.0 / k] * k)


def difference_of(a, b) -> LinearCombinationBatch:
    """a_i - b_i as N two-term combinations."""
    values = torch.stack([a, b], dim=1)
    coefficients = _coefficients_like(a, [[1.0, -1.0]]).expand(values.shape[0], 2)
    return LinearCombinationBatch(values, coefficients)
