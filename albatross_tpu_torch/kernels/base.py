"""Covariance-function combinator algebra.

Counterpart of ``albatross_tpu.kernels.base``.  Each kernel implements a
batch-level ``_matrix(X, Y, x_meas, y_meas) -> (N, M) tensor or None``;
``None`` means "undefined for this pair", composition nodes fall back to
the defined side, and a fully undefined call raises.  ``matrix_or_none``
is the caller chain: it unwraps Measurement tags into flags, assembles a
TaggedBatch's gram from per-tag blocks (kernels/variants.py), and
integrates a LinearCombinationBatch by one gram over its flattened
features contracted with the coefficients.  ``call_trace`` evaluates every
node of the expression tree for one feature pair through that chain.
"""

from __future__ import annotations

import numbers
from typing import Optional

import numpy as np
import torch

from .. import config
from ..core.module import Module
from .features import LinearCombinationBatch, Measurement, strip_measurement


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

    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        """The block of variant tags (tx, ty); plain kernels apply to every
        tag's sub-batch (ForTag restricts them)."""
        return self._matrix(X, Y, x_meas, y_meas)

    def _tagged_diag(self, X, tx, x_meas):
        return self._diag(X, x_meas)

    def matrix_or_none(self, X, Y) -> Optional[torch.Tensor]:
        X, x_meas = strip_measurement(X)
        Y, y_meas = strip_measurement(Y)
        return self._linear_combination_matrix(X, Y, x_meas, y_meas)

    def _linear_combination_matrix(self, X, Y, x_meas, y_meas):
        """K = C_x G C_y^T: the gram G over the flattened base features,
        contracted with each side's coefficients; without a linear
        combination, the gram itself (per-tag blocks for a TaggedBatch).

        The JAX package checks for a TaggedBatch first, so a TaggedBatch
        against a linear combination raises there; here the combination is
        integrated around the tagged gram (what predicting a
        ``difference_of`` from a fit over mixed features needs).  Every
        other pairing takes the JAX package's route."""
        from .variants import TaggedBatch, tagged_gram

        if isinstance(X, LinearCombinationBatch):
            base = self._linear_combination_matrix(X.flat_values(), Y, x_meas, y_meas)
            if base is None:
                return None
            n, k = X.coefficients.shape
            return torch.einsum("nk,nkm->nm", X.coefficients, base.reshape(n, k, -1))
        if isinstance(Y, LinearCombinationBatch):
            base = self._linear_combination_matrix(X, Y.flat_values(), x_meas, y_meas)
            if base is None:
                return None
            m, k = Y.coefficients.shape
            return torch.einsum("mk,nmk->nm", Y.coefficients, base.reshape(-1, m, k))
        if isinstance(X, TaggedBatch):
            return tagged_gram(self, X, Y, x_meas, y_meas)
        if isinstance(Y, TaggedBatch):
            return tagged_gram(self, Y, X, y_meas, x_meas).T
        return self._matrix(X, Y, x_meas, y_meas)

    def diag(self, X) -> torch.Tensor:
        from .variants import TaggedBatch, tagged_diag

        X, x_meas = strip_measurement(X)
        if isinstance(X, TaggedBatch):
            return tagged_diag(self, X, x_meas)
        if isinstance(X, LinearCombinationBatch):
            # diag of C G C^T: each combination's k x k block of the gram
            flat = X.flat_values()
            base = self._matrix(flat, flat, x_meas, x_meas)
            if base is None:
                raise TypeError(f"{self.name}: undefined feature type")
            n, k = X.coefficients.shape
            idx = torch.arange(n, device=base.device)
            per = base.reshape(n, k, n, k)[idx, :, idx, :]  # (n, k, k)
            return torch.einsum("nk,nkl,nl->n", X.coefficients, per, X.coefficients)
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

    def call_trace(self, x, y) -> "CallTreeNode":
        """The whole expression tree evaluated for one feature pair."""
        return _trace(self, x, y)

    def pretty_string(self, indent: int = 0) -> str:
        return "  " * indent + self.name


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

    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        return _combine(
            self.lhs._tagged_matrix(X, Y, tx, ty, x_meas, y_meas),
            self.rhs._tagged_matrix(X, Y, tx, ty, x_meas, y_meas),
            torch.add,
        )

    def _tagged_diag(self, X, tx, x_meas):
        return _combine(
            self.lhs._tagged_diag(X, tx, x_meas), self.rhs._tagged_diag(X, tx, x_meas), torch.add
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

    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        return _combine(
            self.lhs._tagged_matrix(X, Y, tx, ty, x_meas, y_meas),
            self.rhs._tagged_matrix(X, Y, tx, ty, x_meas, y_meas),
            torch.mul,
        )

    def _tagged_diag(self, X, tx, x_meas):
        return _combine(
            self.lhs._tagged_diag(X, tx, x_meas), self.rhs._tagged_diag(X, tx, x_meas), torch.mul
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


class CallTreeNode:
    """One node of a call trace: the kernel's name, its value for the pair,
    and its children's nodes."""

    def __init__(self, name: str, value: float, children):
        self.name = name
        self.value = value
        self.children = children

    def pretty(self, indent: int = 0) -> str:
        lines = ["  " * indent + f"{self.name}: {self.value:.6g}"]
        for child in self.children:
            lines.append(child.pretty(indent + 1))
        return "\n".join(lines)

    def __repr__(self):
        return self.pretty()


def _batch_one(feature):
    """One feature as a 1-element batch, keeping the caller chain's
    wrappers, so every traced node sees what a gram evaluation would.  A
    tensor keeps its device; other values go to ``config.device(None)``."""
    from .variants import TaggedBatch

    if isinstance(feature, Measurement):
        return Measurement(_batch_one(feature.value))
    if isinstance(feature, (LinearCombinationBatch, TaggedBatch)):
        return feature  # already batches
    if isinstance(feature, torch.Tensor):
        return feature[None]
    if isinstance(feature, (numbers.Number, np.ndarray, list, tuple)):
        return torch.as_tensor(feature, device=config.device(None))[None]
    return feature  # a custom feature batch (a ConstantTerm, a user kind)


def _trace(kernel: CovarianceFunction, x, y) -> CallTreeNode:
    """Each node evaluated through ``matrix_or_none``, so measurement-only
    terms, linear combinations and variant blocks show their true values;
    an undefined node reads NaN."""
    result = kernel.matrix_or_none(_batch_one(x), _batch_one(y))
    value = float(result.reshape(-1)[0]) if result is not None else float("nan")
    children = [_trace(child, x, y) for attr in ("lhs", "rhs", "sub")
                if isinstance(child := getattr(kernel, attr, None), CovarianceFunction)]
    return CallTreeNode(kernel.name, value, children)
