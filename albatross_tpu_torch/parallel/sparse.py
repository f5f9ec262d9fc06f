"""Mesh-distributed sparse GP (FITC / PITC) on ``torch.distributed``.

Counterpart of ``albatross_tpu.parallel.sparse``:

* K_fu is row-sharded over the mesh axis: each rank builds its own
  (N/D, M) rows (``sharded_cross_gram``, the gram kernel's cross form on
  the card);
* FITC's diagonal A and PITC's block-diagonal A are factored where the
  rows live.  A PITC group that straddles two ranks' rows is never split:
  the later rank also builds the group's rows before its first row (the
  features are replicated), factors the whole block and keeps its own rows
  of the whitened pieces; the earlier rank factors the leading part of
  the block up to its last row, whose Cholesky factor is the leading part
  of the whole block's.  Each row of A^-1/2 K_fu, of A^-1/2 y and of
  diag(chol(A)) is then that of the single-process fit, on exactly one
  rank;
* B = [A^-1/2 K_fu; K_uu^T/2] is factored by a TSQR: one local QR a rank,
  one QR of the gathered (D M, M) stack of R factors with K_uu^T/2 folded
  in, the diagonal made non-negative.  Both QRs run in f64 for f32 rows,
  as the single-process ``_tall_qr`` does (cuSOLVER's f32 QR is
  inaccurate on tall matrices).  R's gradient goes through R^T R = B^T B
  (``_TSQR``), not through the local QRs;
* v = R^-1 R^-T (B^T y) from one reduction of local products, and the
  NLML by the determinant lemma from reductions of local sums; for f32
  rows both use the f64 R and products.

The M x M results (R, K_uu's factor, v) are replicated: prediction is the
single-process ``SparseGPFit``'s.  Every rank calls with the same
features and targets; the gradient of the NLML reaches every rank whole
(``_comm``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dataset import RegressionDataset, feature_count, first_leaf
from ..kernels.features import as_measurement
from ..models.sparse_gp import (
    SPARSE_R_NUGGET,
    SparseGaussianProcessRegression,
    SparseGPFit,
    _numerical_rank,
    _residual_factor,
    _rows,
)
from ..ops.block import DiagonalCholesky
from ..ops.compensated import accurate_sum_of_logs
from ._comm import Axis, all_reduce_sum, gather_rows, mesh_axis, vary
from .cholesky import _local_rows
from .gram import _varied, sharded_cross_gram

LOG_2PI = math.log(2.0 * math.pi)


def _check_rows(n: int, m: int, ax: Axis) -> None:
    if n % ax.size != 0:
        raise ValueError(f"N={n} not divisible by mesh axis size {ax.size}")
    if n // ax.size < m:
        raise ValueError(f"TSQR needs n/D >= m rows per device (got {n // ax.size} < {m})")


def _tsqr_r(B_local: torch.Tensor, ax: Axis, extra, work: torch.dtype) -> torch.Tensor:
    """The TSQR's R in ``work``, diagonal made non-negative."""
    m = B_local.shape[1]
    stack = gather_rows(torch.linalg.qr(B_local.to(work), mode="r")[1], ax, m)  # (D m, m)
    if extra is not None:
        stack = torch.cat([stack, extra.to(work)])
    R = torch.linalg.qr(stack, mode="r")[1]
    return R * torch.where(torch.diagonal(R) < 0, -1.0, 1.0).to(work)[:, None]


class _TSQR(torch.autograd.Function):
    """R of qr([B; extra]) with a gradient through R^T R = B^T B: R is the
    transposed Cholesky factor of G = sum over ranks of B_d^T B_d plus
    extra^T extra, so dG reaches each rank's rows as B_d (dG + dG^T), with
    no collective.  The QR's own backward would solve with each rank's
    local R_d, which is singular where a rank's rows see none of some
    inducing points (their columns of K_fu underflow to 0)."""

    @staticmethod
    def forward(ctx, B_local, extra, ax, work):
        R = _tsqr_r(B_local, ax, extra, work)
        ctx.save_for_backward(B_local, extra, R)
        ctx.work = work
        return R

    @staticmethod
    def backward(ctx, gR):
        B_local, extra, R = ctx.saved_tensors
        with torch.enable_grad():
            G = (R.T @ R).requires_grad_(True)
            (gG,) = torch.autograd.grad(torch.linalg.cholesky(G), G, gR.mT)
        gG = gG + gG.mT
        g_extra = None if extra is None else (extra.to(ctx.work) @ gG).to(extra.dtype)
        return (B_local.to(ctx.work) @ gG).to(B_local.dtype), g_extra, None, None


def _tsqr(B_local: torch.Tensor, ax: Axis, extra=None) -> torch.Tensor:
    """R of qr([B; extra]) from each rank's rows of B, replicated, with a
    non-negative diagonal; in f64 for f32 rows (and returned in f64)."""
    work = torch.float64 if B_local.dtype == torch.float32 else B_local.dtype
    tracked = torch.is_grad_enabled() and (B_local.requires_grad or (extra is not None and extra.requires_grad))
    if not tracked:
        return _tsqr_r(B_local, ax, extra, work)
    return _TSQR.apply(B_local, extra, ax, work)


def distributed_tall_qr(B, mesh, axis: str = "data", extra=None) -> torch.Tensor:
    """R factor of qr([B; extra]) with B row-sharded over ``axis`` (a
    ``Shard(0)`` DTensor, or a matrix every rank holds whole): a TSQR.

    B is (n, m) with n divisible by the axis size D and n/D >= m; the
    ``extra`` (k, m) rows join the reduction stage.  Returns R (m, m),
    upper-triangular with a non-negative diagonal, in B's dtype,
    replicated."""
    ax = mesh_axis(mesh, axis)
    n, m = B.shape
    _check_rows(n, m, ax)
    B_local = _local_rows(B, mesh, axis, ax)
    return _tsqr(B_local, ax, extra).to(B_local.dtype)


def _local_groups(sizes, r0: int, r1: int):
    """(lo, local sizes): this rank's rows r0..r1 extended back to the start
    ``lo`` of the group that holds row r0, and the sizes of the groups from
    there, the last one cut at r1.  FITC (sizes None) keeps (r0, None)."""
    if sizes is None:
        return r0, None
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    g = int(np.searchsorted(offsets, r0, side="right")) - 1
    lo, local = int(offsets[g]), []
    while offsets[g] < r1:
        local.append(int(min(offsets[g + 1], r1) - offsets[g]))
        g += 1
    return lo, local


def _factor_diagonal(A_chol) -> torch.Tensor:
    """diag(chol(A)) in row order."""
    if isinstance(A_chol, DiagonalCholesky):
        return A_chol.sqrt_diag
    return A_chol._layout.unsplit(torch.diagonal(A_chol.L, dim1=1, dim2=2))


class DistributedSparseGaussianProcessRegression(SparseGaussianProcessRegression):
    """Sparse GP whose fit-time linear algebra is mesh-distributed.

    Prediction is inherited (the ``SparseGPFit`` state is O(M), replicated);
    so is ``update``, on the row-sharded K_fu gathered whole.  N must
    divide the mesh axis size, with at least M rows a rank."""

    def __init__(self, covariance, mesh, axis: str = "data", **kw):
        super().__init__(covariance, **kw)
        self.mesh = mesh
        self.axis = axis

    def _cross_covariance(self, measurements, inducing_features):
        """K_fu from each rank's rows, gathered (the dense single-process
        cross gram when N does not divide the mesh axis)."""
        ax = mesh_axis(self.mesh, self.axis)
        if feature_count(measurements) % ax.size != 0:
            return super()._cross_covariance(measurements, inducing_features)
        rows = sharded_cross_gram(self.covariance_function, measurements, inducing_features, self.mesh,
                                  self.axis).to_local()
        return gather_rows(rows, ax, rows.shape[0])

    def _sharded_pieces(self, inducing_features, features, targets):
        """(the mesh axis, K_uu's factor, this rank's rows of A^-1/2 K_fu and
        of A^-1/2 (y - m(X)), the log-determinant of A over those rows, N)."""
        ax = mesh_axis(self.mesh, self.axis)
        reordered, target_mean, target_var, sizes = self._in_group_order(features, targets)
        n = feature_count(reordered)
        K_uu_chol = self._inducing_factor(inducing_features)
        _check_rows(n, K_uu_chol.L.shape[0], ax)
        b = n // ax.size
        r0, r1 = ax.rank * b, (ax.rank + 1) * b
        lo, local_sizes = _local_groups(sizes, r0, r1)
        device = first_leaf(reordered).device
        kernel = _varied(self.covariance_function, ax, device)
        K_fu = sharded_cross_gram(self.covariance_function, as_measurement(reordered), inducing_features,
                                  self.mesh, self.axis).to_local()
        if lo < r0:  # the rows of a straddling group before this rank's first row
            K_fu = torch.cat([kernel.matrix_or_none(as_measurement(_rows(reordered, lo, r0)), inducing_features),
                              K_fu])
        P = torch.linalg.solve_triangular(vary(K_uu_chol.L, ax), K_fu.T, upper=False)
        nugget = self.measurement_nugget.value
        if isinstance(nugget, torch.Tensor):
            # on the device, as _varied's parameters: a CPU nugget's backward
            # all-reduce would run on autograd's CPU thread, concurrently with
            # the device thread's, in an order that differs between ranks
            nugget = vary(nugget.to(device), ax)
        variance = None if target_var is None else vary(target_var, ax)[lo:r1]
        A_chol = _residual_factor(kernel, _rows(reordered, lo, r1), variance, P, local_sizes, nugget)
        y = vary(self.mean_function.remove_from(reordered, target_mean), ax)[lo:r1]
        skip = r0 - lo
        phi = A_chol.sqrt_solve(K_fu)[skip:]
        y_t = A_chol.sqrt_solve(y)[skip:]
        log_det_a = 2.0 * accurate_sum_of_logs(_factor_diagonal(A_chol)[skip:])
        return ax, K_uu_chol, phi, y_t, log_det_a, n

    def _fit_impl(self, features, targets) -> SparseGPFit:
        u = self.inducing_point_strategy(self.covariance_function, features)
        ax, K_uu_chol, phi, y_t, _, n = self._sharded_pieces(u, features, targets)
        m = K_uu_chol.L.shape[0]
        R = _tsqr(phi, ax, extra=K_uu_chol.L.T)
        rank = int(_numerical_rank(R.to(phi.dtype), n + m))
        if rank < m:
            R = R + SPARSE_R_NUGGET * torch.eye(m, dtype=R.dtype, device=R.device)
        # v = R^-1 Q_1^T y_aug = R^-1 R^-T (B^T y_aug); K_uu^T/2 meets y_aug's zeros
        bty = all_reduce_sum(phi.to(R.dtype).T @ y_t.to(R.dtype), ax)
        v = torch.linalg.solve_triangular(R, torch.linalg.solve_triangular(R.T, bty[:, None], upper=False),
                                          upper=True)[:, 0]
        return SparseGPFit(u, K_uu_chol, R.to(phi.dtype), v.to(phi.dtype), rank)

    def log_likelihood(self, dataset: RegressionDataset) -> torch.Tensor:
        """Log marginal likelihood by the determinant lemma on sharded
        pieces, plus the parameters' prior log-pdfs:
        y^T A^-1 y = |A^-1/2 y|^2 and K_fu^T A^-1 y = (A^-1/2 K_fu)^T A^-1/2 y
        are sums over the ranks' rows."""
        u = self.inducing_point_strategy(self.covariance_function, dataset.features)
        ax, K_uu_chol, phi, y_t, log_det_a, n = self._sharded_pieces(u, dataset.features, dataset.targets)
        R = _tsqr(phi, ax, extra=K_uu_chol.L.T)
        log_det = (all_reduce_sum(log_det_a, ax) + 2.0 * accurate_sum_of_logs(torch.abs(torch.diagonal(R)))
                   - K_uu_chol.log_determinant())
        bty = all_reduce_sum(phi.to(R.dtype).T @ y_t.to(R.dtype), ax)
        y_b = torch.linalg.solve_triangular(R.T, bty[:, None], upper=False)[:, 0]
        log_quadratic = all_reduce_sum(torch.sum(y_t * y_t), ax) - torch.sum(y_b * y_b)
        ll = (-0.5 * (log_det + log_quadratic + n * LOG_2PI)).to(y_t.dtype)
        return ll + self.prior_log_likelihood().to(device=ll.device, dtype=ll.dtype)


def distributed_sparse_gp_from_covariance(covariance, mesh, axis: str = "data",
                                          **kw) -> DistributedSparseGaussianProcessRegression:
    return DistributedSparseGaussianProcessRegression(covariance, mesh, axis, **kw)
