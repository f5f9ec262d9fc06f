"""Sparse Gaussian-process regression (FITC / PITC).

Counterpart of ``albatross_tpu.models.sparse_gp``: Snelson & Ghahramani's
FITC and Quinonero-Candela & Rasmussen's PITC in the QR-stabilized form of
Foster et al. 2009:

    A = blockdiag(K_ff - Q_ff) + nugget          one block per group
    B = [A^{-1/2} K_fu; K_uu^{T/2}] = Q R        (tall QR)
    v = R^{-1} Q^T [A^{-1/2} y; 0]
    predict:  m* = K_*u^T v
              C* = K_** - Q_sqrt^T Q_sqrt + S_sqrt^T S_sqrt
              with Q_sqrt = K_uu^{-1/2} K_u*, S_sqrt = R^{-T} K_u*
    NLML by the matrix determinant lemma.

The cross covariance K_fu, the inducing gram K_uu and each PITC group's
block are radial grams (the gram kernel on the card); K_uu's factorization
is ``CholeskyFactor.factorize`` (the panel kernel's blocked loop above
n = 2048 in f32 on the card); the PITC blocks are identity-padded to one
size and factored by one batched library Cholesky (ops/block.py), as the
JAX package uses XLA's.  The QR is ``torch.linalg.qr`` (cuSOLVER's geqrf on
the card, in f64 for f32 inputs: cuSOLVER's f32 QR is inaccurate on tall
matrices), reduced mode when autograd needs Q, R alone otherwise.  QR signs
may differ from the JAX package's; v, the predictions, |diag R| and
S_sqrt^T S_sqrt do not depend on them.

FITC (every point its own group, ``EveryPointGrouper``) keeps the training
order and a diagonal A: no grouping pass over the N singleton groups.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.dataset import RegressionDataset, feature_count, subset_features
from ..core.distributions import JointDistribution, MarginalDistribution
from ..core.parameters import Parameter, map_join
from ..core.priors import LogScaleUniformPrior
from ..indexing.grouping import group_by
from ..kernels.base import CovarianceFunction
from ..kernels.features import Measurement, as_measurement
from ..kernels.means import MeanFunction, ZeroMean
from ..ops.block import BlockDiagonalCholesky, DiagonalCholesky, pad_blocks
from ..ops.blocked_cholesky import cholesky
from ..ops.compensated import accurate_sum_of_logs
from ..ops.linalg import CholeskyFactor
from ..utils.profiling import named_scope
from .base import FitModel, ModelBase

DEFAULT_NUGGET = 1e-8
SPARSE_R_NUGGET = 1e-10
MEASUREMENT_NUGGET_NAME = "measurement_nugget"
INDUCING_NUGGET_NAME = "inducing_nugget"
PARAMETER_EPSILON = 2.220446049250313e-16
PARAMETER_MAX = 1.7976931348623157e308
LOG_2PI = math.log(2.0 * math.pi)


class UniformlySpacedInducingPoints:
    """``num_points`` evenly spaced over the range of 1-D features (one
    read-back of the range)."""

    def __init__(self, num_points: int = 10):
        self.num_points = num_points

    def __call__(self, covariance, features):
        x = features.detach().reshape(-1)
        lo, hi = torch.stack(torch.aminmax(x)).tolist()
        return torch.linspace(lo, hi, self.num_points, dtype=x.dtype, device=x.device)


class StateSpaceInducingPointStrategy:
    """The covariance function's own grid (``state_space_representation``)."""

    def __call__(self, covariance, features):
        ssr = covariance.state_space_representation(features)
        if ssr is None:
            raise TypeError("covariance function has no state_space_representation for these features")
        return ssr


class EveryPointGrouper:
    """Each point its own group: FITC (fully independent)."""

    def __call__(self, features):
        return np.arange(feature_count(features))


@dataclasses.dataclass(frozen=True)
class SparseGPFit:
    """Trained sparse-GP state."""

    train_features: Any  # the inducing features u
    train_covariance: CholeskyFactor  # K_uu's factorization
    R: torch.Tensor  # upper triangle of the QR of B
    information: torch.Tensor  # v
    numerical_rank: int

    def shift_mean(self, mean_shift) -> "SparseGPFit":
        """information += K_uu^-1 shift."""
        return dataclasses.replace(self, information=self.information + self.train_covariance.solve(mean_shift))


def _numerical_rank(R: torch.Tensor, rows: int) -> torch.Tensor:
    diag = torch.abs(torch.diagonal(R))
    tol = torch.finfo(R.dtype).eps * rows * torch.max(diag)
    return torch.sum(diag > tol)


@named_scope("albatross.sparse.qr")
def _tall_qr(B: torch.Tensor, mode: str):
    """``torch.linalg.qr`` of tall B, run in f64 when B is f32; Q stays in
    f64, R comes back in B's dtype.  cuSOLVER's f32 QR loses accuracy on
    tall matrices (|diag R| 5.7e-2 off at 33792 x 1024 on an H100, where
    its f64 QR of the same B is 1.8e-5 off in the same time; PERF.md)."""
    if B.dtype != torch.float32:
        return torch.linalg.qr(B, mode=mode)
    Q, R = torch.linalg.qr(B.double(), mode=mode)
    return Q, R.float()


def _qr_r_and_v(B: torch.Tensor, y_augmented: torch.Tensor):
    """QR of tall B: (R, v = R^-1 Q^T y, numerical rank).  Where the rank
    drops, R's diagonal is inflated by SPARSE_R_NUGGET (the reference's
    safeguard).  Reads the rank back to the host."""
    m = B.shape[1]
    Q, R = _tall_qr(B, "reduced")
    rank = int(_numerical_rank(R, B.shape[0]))
    if rank < m:
        R = R + SPARSE_R_NUGGET * torch.eye(m, dtype=R.dtype, device=R.device)
    qty = (Q.T @ y_augmented.to(Q.dtype)).to(R.dtype)
    v = torch.linalg.solve_triangular(R, qty[:, None], upper=True)[:, 0]
    return R, v, rank


def _r_sqrt_solve(R: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """R^-T rhs."""
    rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
    out = torch.linalg.solve_triangular(R.T, rhs2d, upper=False)
    return out if rhs.ndim > 1 else out[:, 0]


def _rows(features, start: int, stop: int):
    """Rows start..stop of a feature batch, as a view."""
    if isinstance(features, Measurement):
        return Measurement(_rows(features.value, start, stop))
    return features[start:stop]


def _residual_factor(kernel, features, target_var, P, sizes, nugget):
    """A = blockdiag(K_ff - Q_ff) + nugget over ``features`` (rows in group
    order, ``sizes`` the groups', None for FITC), Q_ff = P^T P, factored:
    a DiagonalCholesky when every group is one point, else a
    BlockDiagonalCholesky."""
    if sizes is None or all(s == 1 for s in sizes):
        # FITC: A is diagonal.  The residual k - q is ~0 where the
        # inducing set covers a training point and can round a few ulps
        # negative in f32; clamp only rounding-scale negatives (window
        # 1e-3 of the magnitudes: P carries K_uu's solve error, ~kappa
        # eps), so a genuinely indefinite residual still surfaces as NaN.
        k_diag = kernel.diag(as_measurement(features))
        if target_var is not None:
            k_diag = k_diag + target_var
        q_diag = torch.sum(P * P, dim=0)
        raw = k_diag - q_diag
        scale = k_diag + q_diag
        raw = torch.where((raw < 0) & (raw >= -1e-3 * scale), torch.zeros_like(raw), raw)
        return DiagonalCholesky(torch.sqrt(raw + nugget))
    # PITC: A_g = K_g - Q_g + nugget per group, identity-padded to one
    # size and factored by one batched Cholesky
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    blocks = []
    for start, stop in zip(offsets[:-1], offsets[1:]):
        Kg = kernel(as_measurement(_rows(features, start, stop)))
        if target_var is not None:
            Kg = Kg + torch.diag(target_var[start:stop])
        P_cols = P[:, start:stop]
        Ag = Kg - P_cols.T @ P_cols
        blocks.append(Ag + nugget * torch.eye(stop - start, dtype=Kg.dtype, device=Kg.device))
    stacked, block_sizes = pad_blocks(blocks)
    return BlockDiagonalCholesky(cholesky(stacked), block_sizes)


class SparseGaussianProcessRegression(ModelBase):
    """FITC / PITC sparse GP; ``grouper`` picks the blocks of A (default
    FITC), ``inducing_point_strategy`` the inducing features."""

    def __init__(
        self,
        covariance: CovarianceFunction,
        mean: Optional[MeanFunction] = None,
        grouper: Optional[Callable] = None,
        inducing_point_strategy: Optional[Callable] = None,
        model_name: Optional[str] = None,
        measurement_nugget: float = DEFAULT_NUGGET,
        inducing_nugget: float = DEFAULT_NUGGET,
    ):
        self.covariance_function = covariance
        self.mean_function = mean if mean is not None else ZeroMean()
        self.grouper = grouper if grouper is not None else EveryPointGrouper()
        self.inducing_point_strategy = (inducing_point_strategy if inducing_point_strategy is not None
                                        else UniformlySpacedInducingPoints())
        self._model_name = model_name
        self.measurement_nugget = Parameter(measurement_nugget,
                                            LogScaleUniformPrior(PARAMETER_EPSILON, PARAMETER_MAX))
        self.inducing_nugget = Parameter(inducing_nugget, LogScaleUniformPrior(PARAMETER_EPSILON, PARAMETER_MAX))

    @property
    def model_name(self) -> str:
        return self._model_name or f"sparse_mean:{self.mean_function.name}cov:{self.covariance_function.name}"

    def get_params(self):
        params = map_join(self.mean_function.get_params(), self.covariance_function.get_params())
        params[MEASUREMENT_NUGGET_NAME] = self.measurement_nugget
        params[INDUCING_NUGGET_NAME] = self.inducing_nugget
        return params

    def _cross_covariance(self, measurements, inducing_features):
        """K_fu."""
        return self.covariance_function.matrix_or_none(measurements, inducing_features)

    def _group_order(self, features):
        """(order, sizes): the training points in group order and the group
        sizes, or (None, None) for FITC in the training order."""
        if isinstance(self.grouper, EveryPointGrouper):
            return None, None
        indexers = group_by(features, self.grouper).indexers()
        values = indexers.values()
        return np.concatenate(values), [len(idx) for idx in values]

    def _in_group_order(self, features, targets: MarginalDistribution):
        """(features, target mean, target variance, group sizes) with the
        rows in group order; sizes None for FITC in the training order."""
        order, sizes = self._group_order(features)
        reordered, target_mean, target_var = features, targets.mean, targets.variance
        if order is not None:
            idx = torch.as_tensor(order, device=target_mean.device)
            reordered, target_mean = subset_features(features, idx), target_mean[idx]
            target_var = None if target_var is None else target_var[idx]
        return reordered, target_mean, target_var, sizes

    def _inducing_factor(self, inducing_features) -> CholeskyFactor:
        """K_uu + inducing nugget, factored."""
        K_uu = self.covariance_function(inducing_features)
        K_uu = K_uu + self.inducing_nugget.value * torch.eye(K_uu.shape[0], dtype=K_uu.dtype, device=K_uu.device)
        return CholeskyFactor.factorize(K_uu)

    @named_scope("albatross.sparse.components")
    def _compute_internal_components(self, inducing_features, features, targets: MarginalDistribution):
        """(A's factorization, K_uu's, K_fu, y - m(X)), rows in group
        order."""
        reordered, target_mean, target_var, sizes = self._in_group_order(features, targets)
        K_fu = self._cross_covariance(as_measurement(reordered), inducing_features)
        K_uu_chol = self._inducing_factor(inducing_features)
        P = K_uu_chol.sqrt_solve(K_fu.T)  # Q_ff = P^T P

        A_chol = _residual_factor(self.covariance_function, reordered, target_var, P, sizes,
                                  self.measurement_nugget.value)
        y = self.mean_function.remove_from(reordered, target_mean)
        return A_chol, K_uu_chol, K_fu, y

    @staticmethod
    def _augmented(A_chol, K_uu_chol, K_fu):
        """B = [A^{-1/2} K_fu; L_uu^T]."""
        return torch.cat([A_chol.sqrt_solve(K_fu), K_uu_chol.L.T], dim=0)

    def _fit_impl(self, features, targets: MarginalDistribution) -> SparseGPFit:
        u = self.inducing_point_strategy(self.covariance_function, features)
        A_chol, K_uu_chol, K_fu, y = self._compute_internal_components(u, features, targets)
        B = self._augmented(A_chol, K_uu_chol, K_fu)
        y_aug = torch.cat([A_chol.sqrt_solve(y), y.new_zeros(K_uu_chol.L.shape[0])])
        R, v, rank = _qr_r_and_v(B, y_aug)
        return SparseGPFit(u, K_uu_chol, R, v, rank)

    def _update_impl(self, fit: SparseGPFit, features, targets: MarginalDistribution) -> SparseGPFit:
        """B = [R_old; A^{-1/2} K_fu], y = [R_old v_old; A^{-1/2} y] on the
        fit's inducing features."""
        A_chol, _, K_fu, y = self._compute_internal_components(fit.train_features, features, targets)
        B = torch.cat([fit.R, A_chol.sqrt_solve(K_fu)], dim=0)
        y_aug = torch.cat([fit.R @ fit.information, A_chol.sqrt_solve(y)])
        R, v, rank = _qr_r_and_v(B, y_aug)
        return SparseGPFit(fit.train_features, fit.train_covariance, R, v, rank)

    def _cross(self, fit: SparseGPFit, features):
        return self.covariance_function.matrix_or_none(fit.train_features, features)

    def _predict_mean(self, features, fit: SparseGPFit):
        return self.mean_function.add_to(features, self._cross(fit, features).T @ fit.information)

    def _predict_marginal(self, features, fit: SparseGPFit) -> MarginalDistribution:
        cross = self._cross(fit, features)
        mean = self.mean_function.add_to(features, cross.T @ fit.information)
        Q_sqrt = fit.train_covariance.sqrt_solve(cross)
        S_sqrt = _r_sqrt_solve(fit.R, cross)
        variance = (self.covariance_function.diag(features) - torch.sum(Q_sqrt * Q_sqrt, dim=0)
                    + torch.sum(S_sqrt * S_sqrt, dim=0))
        return MarginalDistribution(mean, variance)

    def _predict_joint(self, features, fit: SparseGPFit) -> JointDistribution:
        cross = self._cross(fit, features)
        mean = self.mean_function.add_to(features, cross.T @ fit.information)
        Q_sqrt = fit.train_covariance.sqrt_solve(cross)
        S_sqrt = _r_sqrt_solve(fit.R, cross)
        covariance = self.covariance_function(features) - Q_sqrt.T @ Q_sqrt + S_sqrt.T @ S_sqrt
        return JointDistribution(mean, covariance)

    @named_scope("albatross.sparse.log_likelihood")
    def log_likelihood(self, dataset: RegressionDataset) -> torch.Tensor:
        """Log marginal likelihood by the determinant lemma, plus the
        parameters' prior log-pdfs.  Only R of the QR is used: Q is formed
        only when autograd needs it for R's gradient."""
        u = self.inducing_point_strategy(self.covariance_function, dataset.features)
        A_chol, K_uu_chol, K_fu, y = self._compute_internal_components(u, dataset.features, dataset.targets)
        B = self._augmented(A_chol, K_uu_chol, K_fu)
        mode = "reduced" if torch.is_grad_enabled() and B.requires_grad else "r"
        R = _tall_qr(B, mode)[1]

        log_det = (A_chol.log_determinant() + 2.0 * accurate_sum_of_logs(torch.abs(torch.diagonal(R)))
                   - K_uu_chol.log_determinant())
        y_a = A_chol.solve(y)
        y_b = _r_sqrt_solve(R, K_fu.T @ y_a)
        log_quadratic = torch.sum(y * y_a) - torch.sum(y_b * y_b)
        ll = -0.5 * (log_det + log_quadratic + y.shape[0] * LOG_2PI)
        return ll + self.prior_log_likelihood().to(device=ll.device, dtype=ll.dtype)

    def fit_from_prediction(self, new_inducing_points, prediction: JointDistribution) -> FitModel:
        """A sparse fit on ``new_inducing_points`` that reproduces a joint
        prediction there: Sigma = K_zz^-1 C K_zz^-1, so B = C^{-1/2} K_zz."""
        K_zz = self.covariance_function(new_inducing_points)
        train_covariance = CholeskyFactor.factorize(K_zz)
        cov = prediction.covariance + DEFAULT_NUGGET * torch.eye(
            prediction.size, dtype=prediction.covariance.dtype, device=prediction.covariance.device)
        information = train_covariance.solve(prediction.mean)
        sigma_inv_sqrt = CholeskyFactor.factorize(cov).sqrt_solve(K_zz)
        R = torch.linalg.qr(sigma_inv_sqrt, mode="reduced").R
        rank = int(_numerical_rank(R, R.shape[0]))
        return FitModel(self, SparseGPFit(new_inducing_points, train_covariance, R, information, rank))


def rebase_inducing_points(fit_model: FitModel, new_inducing_points) -> FitModel:
    """Move a sparse fit onto new inducing points: predict the joint there,
    then fit_from_prediction."""
    prediction = fit_model.predict(new_inducing_points).joint()
    return fit_model.model.fit_from_prediction(new_inducing_points, prediction)


def sparse_gp_from_covariance(covariance, model_name=None, **kwargs) -> SparseGaussianProcessRegression:
    return SparseGaussianProcessRegression(covariance, model_name=model_name, **kwargs)


def sparse_gp_from_covariance_and_mean(covariance, mean, model_name=None,
                                       **kwargs) -> SparseGaussianProcessRegression:
    return SparseGaussianProcessRegression(covariance, mean, model_name=model_name, **kwargs)
