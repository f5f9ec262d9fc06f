"""Gaussian distribution containers.

Counterpart of ``albatross_tpu.core.distributions``: a
``MarginalDistribution`` is a mean and a variance vector (never a dense
matrix), a ``JointDistribution`` a mean and a dense covariance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _as_float(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


@dataclasses.dataclass(frozen=True)
class MarginalDistribution:
    """Mean + independent (diagonal) variance."""

    mean: torch.Tensor
    variance: Optional[torch.Tensor] = None  # None => zero variance

    @classmethod
    def create(cls, mean, variance=None) -> "MarginalDistribution":
        mean = _as_float(mean)
        if variance is not None:
            variance = torch.broadcast_to(_as_float(variance, mean), mean.shape)
        return cls(mean, variance)

    @property
    def size(self) -> int:
        return self.mean.shape[0]

    def __len__(self) -> int:
        return self.size

    def has_covariance(self) -> bool:
        return self.variance is not None

    def get_variance(self) -> torch.Tensor:
        if self.variance is None:
            return torch.zeros_like(self.mean)
        return self.variance

    def covariance_matrix(self) -> torch.Tensor:
        return torch.diag(self.get_variance())

    def marginal(self) -> "MarginalDistribution":
        return self

    def __repr__(self):
        return (
            f"MarginalDistribution(n={tuple(self.mean.shape)}, "
            f"has_variance={self.variance is not None})"
        )


@dataclasses.dataclass(frozen=True)
class JointDistribution:
    """Mean + dense covariance."""

    mean: torch.Tensor
    covariance: torch.Tensor

    @classmethod
    def create(cls, mean, covariance) -> "JointDistribution":
        mean = _as_float(mean)
        return cls(mean, _as_float(covariance, mean))

    @property
    def size(self) -> int:
        return self.mean.shape[0]

    def __len__(self) -> int:
        return self.size

    def has_covariance(self) -> bool:
        return True

    def marginal(self) -> MarginalDistribution:
        return MarginalDistribution(self.mean, torch.diagonal(self.covariance))

    def covariance_matrix(self) -> torch.Tensor:
        return self.covariance

    def __repr__(self):
        return f"JointDistribution(n={tuple(self.mean.shape)})"
