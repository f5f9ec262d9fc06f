"""Mesh-distributed exact GP: fit, predict, NLML, cross-validation, update.

Counterpart of ``albatross_tpu.parallel.gp``: the pipeline is

    sharded gram (gram.py) -> distributed blocked Cholesky (cholesky.py,
    or cholesky2d.py) -> distributed solves -> predictions / NLML

with every rank holding its rows (the 1-D row layout) or its tile (the
2-D layout, ``col_axis``: N^2/(R C) entries a rank) of the covariance and
of the factor.  ``DistributedCholesky`` and ``DistributedCholesky2D`` offer
the dense ``CholeskyFactor``'s surface (solve, sqrt_solve,
log_determinant, inverse_diagonal, inverse_blocks), each result
replicated, so prediction, fast LOO / LOGO (``held_out_predictions``) and
``update`` (a ``BlockSymmetric`` over the sharded factor) run the
single-process code unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core.dataset import RegressionDataset, feature_count, float_like
from ..core.distributions import MarginalDistribution
from ..kernels.features import as_measurement
from ..models.gp import GaussianProcess, GPFit
from ..ops.linalg import ExplainedBySolve
from .cholesky import (
    distributed_cholesky,
    distributed_inverse_blocks,
    distributed_inverse_diagonal,
    distributed_log_determinant,
    distributed_solve,
    distributed_sqrt_solve,
)
from .cholesky2d import (
    distributed_cholesky_2d,
    distributed_inverse_blocks_2d,
    distributed_inverse_diagonal_2d,
    distributed_log_determinant_2d,
    distributed_solve_2d,
    distributed_sqrt_solve_2d,
)
from .gram import sharded_gram, sharded_gram_2d

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class DistributedCholesky(ExplainedBySolve):
    """Row-sharded Cholesky factor (a ``Shard(0)`` DTensor) bound to its
    mesh."""

    L: torch.Tensor
    mesh: object
    axis: str = "data"

    def solve(self, rhs):
        return distributed_solve(self.L, rhs, self.mesh, self.axis)

    def sqrt_solve(self, rhs):
        return distributed_sqrt_solve(self.L, rhs, self.mesh, self.axis)

    def log_determinant(self):
        return distributed_log_determinant(self.L, self.mesh, self.axis)

    def inverse_diagonal(self):
        return distributed_inverse_diagonal(self.L, self.mesh, self.axis)

    def inverse_blocks(self, indices_groups):
        return distributed_inverse_blocks(self.L, indices_groups, self.mesh, self.axis)


@dataclasses.dataclass(frozen=True)
class DistributedCholesky2D(ExplainedBySolve):
    """Tile-sharded Cholesky factor (a DTensor tiled over ``row_axis`` and
    ``col_axis``) bound to its mesh: N^2/(R C) factor entries a rank."""

    L: torch.Tensor
    mesh: object
    row_axis: str = "data"
    col_axis: str = "model"

    def solve(self, rhs):
        return distributed_solve_2d(self.L, rhs, self.mesh, self.row_axis, self.col_axis)

    def sqrt_solve(self, rhs):
        return distributed_sqrt_solve_2d(self.L, rhs, self.mesh, self.row_axis, self.col_axis)

    def log_determinant(self):
        return distributed_log_determinant_2d(self.L, self.mesh, self.row_axis, self.col_axis)

    def inverse_diagonal(self):
        return distributed_inverse_diagonal_2d(self.L, self.mesh, self.row_axis, self.col_axis)

    def inverse_blocks(self, indices_groups):
        return distributed_inverse_blocks_2d(self.L, indices_groups, self.mesh, self.row_axis, self.col_axis)


class DistributedGaussianProcess(GaussianProcess):
    """Exact GP whose fit-time linear algebra is mesh-distributed.

    Every rank of the mesh calls the same methods with the same data (the
    features, targets and prediction points replicated); each builds and
    factors its own rows of the training covariance.  Prediction math is
    inherited: it only calls ``solve`` on the fit's covariance, which
    dispatches to the distributed factor.  ``col_axis`` selects the 2-D
    tile layout over (``axis``, ``col_axis``); ``panel`` caps its panel
    width, trading collective rounds for the (N, panel) transient (None:
    up to the tile width, at most 1024 where the width allows)."""

    def __init__(
        self,
        covariance,
        mesh,
        mean=None,
        axis: str = "data",
        col_axis: Optional[str] = None,
        panel: Optional[int] = None,
        **kw,
    ):
        super().__init__(covariance, mean, **kw)
        self.mesh = mesh
        self.axis = axis
        self.col_axis = col_axis
        self.panel = panel  # the 2-D layout's panel width; unused by the 1-D layout

    def _sharded_factorize(self, features, target_variance):
        """Sharded training covariance (jitter on its diagonal) and its
        distributed factor, in the layout this model was built with."""
        if self.jitter:
            jitter = torch.full((feature_count(features),), self.jitter, **float_like(features))
            target_variance = jitter if target_variance is None else target_variance + jitter
        if self.col_axis is None:
            K = sharded_gram(self.covariance_function, features, self.mesh, self.axis,
                             measurement=True, target_variance=target_variance)
            return DistributedCholesky(distributed_cholesky(K, self.mesh, self.axis), self.mesh, self.axis)
        K = sharded_gram_2d(self.covariance_function, features, self.mesh, self.axis, self.col_axis,
                            measurement=True, target_variance=target_variance)
        L = distributed_cholesky_2d(K, self.mesh, self.axis, self.col_axis, panel=self.panel)
        return DistributedCholesky2D(L, self.mesh, self.axis, self.col_axis)

    def _fit_impl(self, features, targets: MarginalDistribution) -> GPFit:
        chol = self._sharded_factorize(features, targets.variance)
        zero_mean = self.mean_function.remove_from(as_measurement(features), targets.mean)
        return GPFit(features, chol, chol.solve(zero_mean))

    def log_likelihood(self, dataset: RegressionDataset) -> torch.Tensor:
        measurements = as_measurement(dataset.features)
        zero_mean = self.mean_function.remove_from(measurements, dataset.targets.mean)
        chol = self._sharded_factorize(dataset.features, None)
        white = chol.sqrt_solve(zero_mean)
        n = zero_mean.shape[0]
        nll = 0.5 * (chol.log_determinant() + torch.sum(white * white) + n * LOG_2PI)
        return -nll + self.prior_log_likelihood().to(device=nll.device, dtype=nll.dtype)


def distributed_gp_from_covariance(covariance, mesh, mean=None, **kwargs) -> DistributedGaussianProcess:
    return DistributedGaussianProcess(covariance, mesh, mean, **kwargs)
