"""Dense Cholesky factorization and solves.

Counterpart of ``CholeskyFactor`` in ``albatross_tpu.ops.linalg``: factorize,
factorize_whiten, nlml_terms (materialized-K path), solve, sqrt_solve and
log_determinant.  Above n = 2048 the factorization is the blocked
column-panel loop; at or below it torch.linalg.cholesky plus triangular
solves.
"""

from __future__ import annotations

import dataclasses

import torch

from .blocked_cholesky import blocked_cholesky_cols, cholesky
from .compensated import accurate_sum_of_logs

# the JAX package's blocked-factorization threshold
_BLOCKED_MIN_N = 2048


def _sum_of_logs(diag: torch.Tensor) -> torch.Tensor:
    """2 sum(log d_i) for a Cholesky diagonal, via accurate_sum_of_logs."""
    return 2.0 * accurate_sum_of_logs(diag)


def _prepare(K: torch.Tensor, jitter: float, assume_symmetric: bool) -> torch.Tensor:
    if not assume_symmetric:
        K = 0.5 * (K + K.T)
    if jitter:
        K = K + jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return K


def _lower_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
    y = torch.linalg.solve_triangular(L, rhs2d, upper=False)
    return y if rhs.ndim > 1 else y[:, 0]


@dataclasses.dataclass(frozen=True)
class CholeskyFactor:
    """Lower-triangular Cholesky factor of an SPD matrix."""

    L: torch.Tensor

    @staticmethod
    def _factor_core(K, jitter, rhs, assume_symmetric=False):
        """One place owns the symmetrize/jitter policy and the blocked
        threshold, so the NLML path never factorizes a different matrix
        than the fit path."""
        K = _prepare(K, jitter, assume_symmetric)
        if K.shape[0] > _BLOCKED_MIN_N:
            return blocked_cholesky_cols(K, rhs=rhs)
        L = cholesky(K)
        if rhs is None:
            return L
        return L, _lower_solve(L, rhs)

    @classmethod
    def factorize(cls, K, jitter: float = 0.0, assume_symmetric: bool = False):
        return cls(cls._factor_core(K, jitter, None, assume_symmetric))

    @classmethod
    def factorize_whiten(cls, K, rhs, jitter: float = 0.0, assume_symmetric: bool = False):
        """Factorize K and return (factor, L^-1 rhs); ``rhs`` is (n,)."""
        if rhs.ndim != 1:
            raise ValueError(
                f"factorize_whiten expects a 1-D rhs, got shape {tuple(rhs.shape)};"
                " use factorize(...).sqrt_solve for matrix right-hand sides"
            )
        L, white = cls._factor_core(K, jitter, rhs.to(K.dtype), assume_symmetric)
        return cls(L), white

    @classmethod
    def nlml_terms(cls, K, rhs, jitter: float = 0.0, assume_symmetric: bool = False):
        """(log|K|, L^-1 rhs) without assembling the factor at scale."""
        if rhs.ndim != 1:
            raise ValueError(f"nlml_terms expects a 1-D rhs, got shape {tuple(rhs.shape)}")
        K = _prepare(K, jitter, assume_symmetric)
        rhs = rhs.to(K.dtype)
        if K.shape[0] > _BLOCKED_MIN_N:
            diag, white = blocked_cholesky_cols(K, rhs=rhs, assemble=False)
            return _sum_of_logs(diag), white
        L = cholesky(K)
        return _sum_of_logs(torch.diagonal(L)), _lower_solve(L, rhs)

    @property
    def shape(self):
        return self.L.shape

    @property
    def dtype(self):
        return self.L.dtype

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """A^-1 rhs via two triangular solves."""
        rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
        y = torch.linalg.solve_triangular(self.L, rhs2d, upper=False)
        x = torch.linalg.solve_triangular(self.L.T, y, upper=True)
        return x if rhs.ndim > 1 else x[:, 0]

    def sqrt_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """L^-1 rhs -- the whitening transform."""
        return _lower_solve(self.L, rhs)

    def log_determinant(self) -> torch.Tensor:
        return _sum_of_logs(torch.diagonal(self.L))
