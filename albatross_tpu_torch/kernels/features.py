"""Measurement tags.

Counterpart of the ``Measurement`` and ``LinearCombinationBatch`` parts of
``albatross_tpu.kernels.features``: a ``Measurement`` tags a whole feature
batch as noisy observations (the GP fit wraps its training set exactly
once); a ``LinearCombinationBatch`` holds N combinations of K base
features, as ``core.dataset.transform_dataset`` builds them.  The kernels
that evaluate linear combinations are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any


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


def as_measurement(features) -> Measurement:
    if isinstance(features, Measurement):
        return features
    return Measurement(features)


def strip_measurement(features):
    """Unwrap, returning (raw_features, was_measurement)."""
    if isinstance(features, Measurement):
        return features.value, True
    return features, False
