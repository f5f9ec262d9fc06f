"""Gaussian distribution containers.

Counterpart of ``albatross_tpu.core.distributions``: a
``MarginalDistribution`` is a mean and a variance vector (never a dense
matrix), a ``JointDistribution`` a mean and a dense covariance.  Both add,
subtract (variances add) and scale by a scalar, and transform linearly:
``A @ dist`` and ``dist.transform(A)`` give the joint N(A mu, A C A^T),
``transform_marginal(A)`` its marginal without forming A C A^T.  ``A`` may
be a tensor, a numpy array or a nested list; ``__array_ufunc__ = None``
makes a numpy matrix on the left of ``@`` defer to ``__rmatmul__``.
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

    @property
    def covariance_diagonal(self) -> torch.Tensor:
        return self.get_variance()

    def covariance_matrix(self) -> torch.Tensor:
        return torch.diag(self.get_variance())

    def marginal(self) -> "MarginalDistribution":
        return self

    def __add__(self, other: "MarginalDistribution") -> "MarginalDistribution":
        return MarginalDistribution(self.mean + other.mean, self.get_variance() + other.get_variance())

    def __sub__(self, other: "MarginalDistribution") -> "MarginalDistribution":
        return MarginalDistribution(self.mean - other.mean, self.get_variance() + other.get_variance())

    def __mul__(self, scalar) -> "MarginalDistribution":
        return MarginalDistribution(self.mean * scalar, self.get_variance() * scalar**2)

    __rmul__ = __mul__

    def subset(self, indices) -> "MarginalDistribution":
        idx = as_index(indices, self.mean.device)
        return MarginalDistribution(self.mean[idx], None if self.variance is None else self.variance[idx])

    def set_subset(self, indices, other: "MarginalDistribution") -> "MarginalDistribution":
        """A copy with ``other``'s mean and variance at ``indices``."""
        idx = (as_index(indices, self.mean.device),)
        return MarginalDistribution(self.mean.index_put(idx, other.mean.to(self.mean.dtype)),
                                    self.get_variance().index_put(idx, other.get_variance().to(self.mean.dtype)))

    def transform(self, matrix) -> "JointDistribution":
        """A @ N(mu, diag(v)) = N(A mu, A diag(v) A^T)."""
        A = _as_float(matrix, self.mean)
        return JointDistribution(A @ self.mean, (A * self.get_variance()[None, :]) @ A.T)

    def transform_marginal(self, matrix) -> "MarginalDistribution":
        """The transform's marginal, var_i = sum_j A_ij^2 v_j."""
        A = _as_float(matrix, self.mean)
        return MarginalDistribution(A @ self.mean, (A * A) @ self.get_variance())

    def __rmatmul__(self, matrix) -> "JointDistribution":
        return self.transform(matrix)

    __array_ufunc__ = None

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

    def __add__(self, other) -> "JointDistribution":
        return JointDistribution(self.mean + other.mean, self.covariance + _cov_as_dense(other))

    def __sub__(self, other) -> "JointDistribution":
        return JointDistribution(self.mean - other.mean, self.covariance + _cov_as_dense(other))

    def __mul__(self, scalar) -> "JointDistribution":
        return JointDistribution(self.mean * scalar, self.covariance * scalar**2)

    __rmul__ = __mul__

    def transform(self, matrix) -> "JointDistribution":
        """A @ N(mu, C) = N(A mu, A C A^T)."""
        A = _as_float(matrix, self.mean)
        return JointDistribution(A @ self.mean, A @ self.covariance @ A.T)

    def transform_marginal(self, matrix) -> MarginalDistribution:
        """The transform's marginal, contracted to the diagonal directly."""
        A = _as_float(matrix, self.mean)
        return MarginalDistribution(A @ self.mean, torch.einsum("ij,jk,ik->i", A, self.covariance, A))

    def __rmatmul__(self, matrix) -> "JointDistribution":
        return self.transform(matrix)

    __array_ufunc__ = None

    def subset(self, indices) -> "JointDistribution":
        idx = as_index(indices, self.mean.device)
        return JointDistribution(self.mean[idx], self.covariance[idx][:, idx])

    def __repr__(self):
        return f"JointDistribution(n={tuple(self.mean.shape)})"


def _cov_as_dense(dist) -> torch.Tensor:
    if isinstance(dist, JointDistribution):
        return dist.covariance
    return torch.diag(dist.get_variance())


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
