"""MeasurementOnly covariance wrapper.

Counterpart of ``albatross_tpu.kernels.measurement``: a term that counts
only between Measurement-tagged batches (noise in the training covariance,
not in train/test or test/test covariances).
"""

from __future__ import annotations

import torch

from .base import CovarianceFunction


class MeasurementOnly(CovarianceFunction):
    def __init__(self, sub: CovarianceFunction):
        self.sub = sub

    @property
    def name(self):
        return f"measurement[{self.sub.name}]"

    def _matrix(self, X, Y, x_meas, y_meas):
        inner = self.sub._matrix(X, Y, x_meas, y_meas)
        if inner is None:
            return None
        if x_meas and y_meas:
            return inner
        return torch.zeros_like(inner)

    def _symmetric_exact(self, X):
        return self.sub._symmetric_exact(X)

    def _diag(self, X, x_meas):
        inner = self.sub._diag(X, x_meas)
        if inner is None:
            return None
        if x_meas:
            return inner
        return torch.zeros_like(inner)


def measurement_only(sub: CovarianceFunction) -> MeasurementOnly:
    return MeasurementOnly(sub)
