"""Batched Euclidean distances.

Counterpart of ``EuclideanDistance`` in ``albatross_tpu.kernels.distances``:
exact elementwise broadcast for D <= 8, the |x|^2 + |y|^2 - 2 x.y matmul
form above it.  The radial kernels route CUDA tensors through the gram
kernel (ops/radial_gram.py) and use this only for the plain path.
"""

from __future__ import annotations

import dataclasses

import torch


def as_matrix(X: torch.Tensor) -> torch.Tensor:
    """Coerce a feature batch to (N, D)."""
    if X.ndim == 1:
        return X[:, None]
    if X.ndim == 2:
        return X
    return X.reshape(X.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class EuclideanDistance:
    """|x - y| for scalars, ||x - y|| for vectors."""

    # above this many feature dimensions the matmul form replaces the
    # (N, M, D) broadcast
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

    def diag(self, X) -> torch.Tensor:
        X = as_matrix(X)
        return torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
