"""Batched distance metrics.

Counterpart of ``albatross_tpu.kernels.distances``: each metric gives the
whole (N, M) distance matrix of two feature batches.  Metrics are frozen,
parameter-free dataclasses; a user metric subclasses ``DistanceMetric``.
The radial kernels send a Euclidean metric to the gram kernel
(ops/radial_gram.py) and use ``pairwise`` for every other metric.
"""

from __future__ import annotations

import dataclasses
import math

import torch

EPSILON = 1e-16  # the acos clamping guard of the reference's angular metric


def as_matrix(X: torch.Tensor) -> torch.Tensor:
    """Coerce a feature batch to (N, D)."""
    if X.ndim == 1:
        return X[:, None]
    if X.ndim == 2:
        return X
    return X.reshape(X.shape[0], -1)


def _norms(X: torch.Tensor) -> torch.Tensor:
    """Row norms; on the CPU in f64 equal to the bit to the JAX package's
    ``jnp.linalg.norm`` (a plain sqrt(sum(x * x)) is not, and an ulp in a
    norm moves an angle near 0 by about 1.5e-8)."""
    return torch.linalg.vector_norm(X, dim=-1)


@dataclasses.dataclass(frozen=True)
class DistanceMetric:
    @property
    def name(self) -> str:
        raise NotImplementedError

    def pairwise(self, X, Y) -> torch.Tensor:
        """(N, M) matrix of distances between feature batches."""
        raise NotImplementedError

    def diag(self, X) -> torch.Tensor:
        """Distance of each feature to itself: zero for every metric here."""
        X = as_matrix(X)
        return torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class EuclideanDistance(DistanceMetric):
    """|x - y| for scalars, ||x - y|| for vectors: the exact elementwise
    broadcast for D <= 8, the |x|^2 + |y|^2 - 2 x.y matmul form above."""

    _BROADCAST_MAX_D = 8

    @property
    def name(self) -> str:
        return "euclidean_distance"

    def pairwise_squared(self, X, Y) -> torch.Tensor:
        X, Y = as_matrix(X), as_matrix(Y)
        if X.shape[-1] <= self._BROADCAST_MAX_D:
            diff = X[:, None, :] - Y[None, :, :]
            return torch.sum(diff * diff, dim=-1)
        x2 = torch.sum(X * X, dim=-1)
        y2 = torch.sum(Y * Y, dim=-1)
        d2 = x2[:, None] + y2[None, :] - 2.0 * (X @ Y.T)
        return torch.clamp_min(d2, 0.0)

    def pairwise(self, X, Y) -> torch.Tensor:
        X, Y = as_matrix(X), as_matrix(Y)
        if X.shape[-1] == 1:
            return torch.abs(X[:, 0][:, None] - Y[:, 0][None, :])
        return torch.sqrt(self.pairwise_squared(X, Y))


@dataclasses.dataclass(frozen=True)
class RadialDistance(DistanceMetric):
    """| ||x|| - ||y|| |."""

    @property
    def name(self) -> str:
        return "radial_distance"

    def pairwise(self, X, Y) -> torch.Tensor:
        X, Y = as_matrix(X), as_matrix(Y)
        return torch.abs(_norms(X)[:, None] - _norms(Y)[None, :])


@dataclasses.dataclass(frozen=True)
class AngularDistance(DistanceMetric):
    """Great-circle angle, acos of the normalized dot products, with the
    reference's special cases near +-1.

    The product X Y^T runs at full f32 (TF32 is off, config.py), as the JAX
    package asks for Precision.HIGHEST.  In f32, 1 - EPSILON rounds to 1, so
    the clamp and the cases do nothing there; acos then resolves no angle
    below about sqrt(2 * 6e-8) ~ 3.5e-4 rad, and the diagonal of K(X, X)
    can come out near 3.5e-4 where ``diag`` gives 0."""

    @property
    def name(self) -> str:
        return "angular_distance"

    def pairwise(self, X, Y) -> torch.Tensor:
        X, Y = as_matrix(X), as_matrix(Y)
        dots = (X @ Y.T) / (_norms(X)[:, None] * _norms(Y)[None, :])
        angles = torch.arccos(torch.clamp(dots, -1.0 + EPSILON, 1.0 - EPSILON))
        zero = torch.zeros_like(angles)
        return torch.where(dots > 1.0 - EPSILON, zero,
                           torch.where(dots < -1.0 + EPSILON, zero + math.pi, angles))
