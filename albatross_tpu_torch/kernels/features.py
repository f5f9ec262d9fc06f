"""Measurement tags.

Counterpart of the ``Measurement`` part of ``albatross_tpu.kernels.features``:
a ``Measurement`` tags a whole feature batch as noisy observations (the GP
fit wraps its training set exactly once).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Tags a feature batch as noisy measurements."""

    value: Any


def as_measurement(features) -> Measurement:
    if isinstance(features, Measurement):
        return features
    return Measurement(features)


def strip_measurement(features):
    """Unwrap, returning (raw_features, was_measurement)."""
    if isinstance(features, Measurement):
        return features.value, True
    return features, False
