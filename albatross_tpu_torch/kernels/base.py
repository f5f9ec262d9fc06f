"""Covariance-function combinator algebra.

Counterpart of ``albatross_tpu.kernels.base``.  Each kernel implements a
batch-level ``_matrix(X, Y, x_meas, y_meas) -> (N, M) tensor or None``;
``None`` means "undefined for this pair", composition nodes fall back to
the defined side, and a fully undefined call raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.module import Module
from .features import strip_measurement


class CovarianceFunction(Module):
    """Base class for covariance kernels."""

    def _matrix(self, X, Y, x_meas: bool, y_meas: bool) -> Optional[torch.Tensor]:
        raise NotImplementedError

    def _diag(self, X, x_meas: bool) -> Optional[torch.Tensor]:
        """Diagonal of the self-covariance; kernels override with O(N)."""
        full = self._matrix(X, X, x_meas, x_meas)
        return None if full is None else torch.diagonal(full)

    def __call__(self, X, Y=None) -> torch.Tensor:
        symmetric = Y is None
        result = self.matrix_or_none(X, X if symmetric else Y)
        if result is None:
            raise TypeError(
                f"covariance {self.name} is undefined for these feature types"
            )
        if symmetric and not self._symmetric_exact(X):
            # matmul-reduction paths can leave epsilon asymmetry, which the
            # Cholesky must not see; elementwise-symmetric kernels skip this
            result = 0.5 * (result + result.T)
        return result

    def _symmetric_exact(self, X) -> bool:
        """True when _matrix(X, X) is bitwise symmetric by construction."""
        return True

    def matrix_or_none(self, X, Y) -> Optional[torch.Tensor]:
        X, x_meas = strip_measurement(X)
        Y, y_meas = strip_measurement(Y)
        return self._matrix(X, Y, x_meas, y_meas)

    def diag(self, X) -> torch.Tensor:
        X, x_meas = strip_measurement(X)
        result = self._diag(X, x_meas)
        if result is None:
            raise TypeError(f"{self.name}: undefined feature type")
        return result

    def __add__(self, other):
        return SumKernel(self, _as_kernel(other))

    def __radd__(self, other):
        return SumKernel(_as_kernel(other), self)

    def __mul__(self, other):
        return ProductKernel(self, _as_kernel(other))

    def __rmul__(self, other):
        return ProductKernel(_as_kernel(other), self)

    def state_space_representation(self, X) -> Optional[torch.Tensor]:
        """1-D inducing grid for this kernel over features X, or None when
        the kernel has none."""
        return None


def _combine(a, b, op):
    if a is None:
        return b
    if b is None:
        return a
    return op(a, b)


class SumKernel(CovarianceFunction):
    """k1 + k2."""

    def __init__(self, lhs: CovarianceFunction, rhs: CovarianceFunction):
        self.lhs = lhs
        self.rhs = rhs

    @property
    def name(self):
        return f"({self.lhs.name}+{self.rhs.name})"

    def _matrix(self, X, Y, x_meas, y_meas):
        return _combine(
            self.lhs._matrix(X, Y, x_meas, y_meas),
            self.rhs._matrix(X, Y, x_meas, y_meas),
            torch.add,
        )

    def _diag(self, X, x_meas):
        return _combine(
            self.lhs._diag(X, x_meas), self.rhs._diag(X, x_meas), torch.add
        )

    def _symmetric_exact(self, X):
        return self.lhs._symmetric_exact(X) and self.rhs._symmetric_exact(X)

    def state_space_representation(self, X):
        return _concat_ssr(self.lhs.state_space_representation(X), self.rhs.state_space_representation(X))


class ProductKernel(CovarianceFunction):
    """k1 * k2; if only one side is defined for a pair, it acts alone."""

    def __init__(self, lhs: CovarianceFunction, rhs: CovarianceFunction):
        self.lhs = lhs
        self.rhs = rhs

    @property
    def name(self):
        return f"({self.lhs.name}*{self.rhs.name})"

    def _matrix(self, X, Y, x_meas, y_meas):
        return _combine(
            self.lhs._matrix(X, Y, x_meas, y_meas),
            self.rhs._matrix(X, Y, x_meas, y_meas),
            torch.mul,
        )

    def _diag(self, X, x_meas):
        return _combine(
            self.lhs._diag(X, x_meas), self.rhs._diag(X, x_meas), torch.mul
        )

    def _symmetric_exact(self, X):
        return self.lhs._symmetric_exact(X) and self.rhs._symmetric_exact(X)

    def state_space_representation(self, X):
        return _concat_ssr(self.lhs.state_space_representation(X), self.rhs.state_space_representation(X))


def _concat_ssr(a, b):
    """Both sides' grids concatenated; a side without one drops out."""
    return _combine(a, b, lambda a, b: torch.cat([torch.atleast_1d(a), torch.atleast_1d(b)]))


def _as_kernel(value) -> CovarianceFunction:
    if isinstance(value, CovarianceFunction):
        return value
    raise TypeError(f"cannot compose covariance with {type(value).__name__}")
