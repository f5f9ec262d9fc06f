"""Gaussian distribution containers.

Counterpart of ``albatross_tpu.core.distributions``: a
``MarginalDistribution`` is a mean and a variance vector (never a dense
matrix), a ``JointDistribution`` a mean and a dense covariance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


def as_index(indices, device) -> torch.Tensor:
    """Row indices (a tensor, numpy array, list or int) as a tensor on
    ``device``: integer indices as int64, a boolean mask as it is."""
    idx = torch.as_tensor(indices, device=device)
    return idx if idx.dtype == torch.bool else idx.long()


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

    def subset(self, indices) -> "MarginalDistribution":
        idx = as_index(indices, self.mean.device)
        return MarginalDistribution(self.mean[idx], None if self.variance is None else self.variance[idx])

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

    def subset(self, indices) -> "JointDistribution":
        idx = as_index(indices, self.mean.device)
        return JointDistribution(self.mean[idx], self.covariance[idx][:, idx])

    def __repr__(self):
        return f"JointDistribution(n={tuple(self.mean.shape)})"


def concatenate_marginals(dists: Sequence[MarginalDistribution]) -> MarginalDistribution:
    """Concatenate independent marginals; the variance stays None only when
    every part has none."""
    mean = torch.cat([d.mean for d in dists])
    if all(d.variance is None for d in dists):
        return MarginalDistribution(mean, None)
    return MarginalDistribution(mean, torch.cat([d.get_variance() for d in dists]))


def concatenate_joints(dists: Sequence[JointDistribution]) -> JointDistribution:
    """Block-diagonal concatenation of independent joints."""
    mean = torch.cat([d.mean for d in dists])
    return JointDistribution(mean, torch.block_diag(*(d.covariance for d in dists)).to(mean.dtype))
