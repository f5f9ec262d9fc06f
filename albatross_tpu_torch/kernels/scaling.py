"""Input-dependent scaling terms: k'(x, y) = s(x) k(x, y) s(y).

Counterpart of ``albatross_tpu.kernels.scaling``.  A ``ScalingFunction``
implements ``_scale(X) -> (N,) tensor`` (or None where it is undefined for
a feature kind); ``ScalingTerm`` makes it the covariance s(x) s(y), which a
``ProductKernel`` multiplies into another term.  Where only one side is
defined the other side's scale is 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dataset import feature_count
from ..core.module import Module
from .base import CovarianceFunction


class ScalingFunction(Module):
    def _scale(self, X) -> Optional[torch.Tensor]:
        raise NotImplementedError

    def __call__(self, X) -> torch.Tensor:
        s = self._scale(X)
        if s is None:
            raise TypeError(f"{self.name}: undefined feature type")
        return s


class ScalingTerm(CovarianceFunction):
    def __init__(self, scaling_function: ScalingFunction):
        self.scaling_function = scaling_function

    @property
    def name(self):
        return self.scaling_function.name

    def _matrix(self, X, Y, x_meas, y_meas):
        sx = self.scaling_function._scale(X)
        sy = self.scaling_function._scale(Y)
        if sx is None and sy is None:
            return None
        if sx is None:
            sx = torch.ones((feature_count(X),), dtype=sy.dtype, device=sy.device)
        if sy is None:
            sy = torch.ones((feature_count(Y),), dtype=sx.dtype, device=sx.device)
        return sx[:, None] * sy[None, :]

    def _diag(self, X, x_meas):
        sx = self.scaling_function._scale(X)
        return None if sx is None else sx * sx
