"""Mean functions: ``MeanFunction`` and ``ZeroMean``.

Counterpart of that part of ``albatross_tpu.kernels.means``; ``add_to`` /
``remove_from`` are the helpers GP fit and predict use.
"""

from __future__ import annotations

import torch

from ..core.module import Module
from .features import strip_measurement


class MeanFunction(Module):
    def _mean(self, X) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, X) -> torch.Tensor:
        X, _ = strip_measurement(X)
        return self._mean(X)

    def add_to(self, X, targets: torch.Tensor) -> torch.Tensor:
        return targets + self(X)

    def remove_from(self, X, targets: torch.Tensor) -> torch.Tensor:
        return targets - self(X)


class ZeroMean(MeanFunction):
    @property
    def name(self):
        return "zero"

    def _mean(self, X):
        return torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
