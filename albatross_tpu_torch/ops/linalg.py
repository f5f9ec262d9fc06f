"""Dense Cholesky factorization and solves.

Counterpart of ``albatross_tpu.ops.linalg``: ``CholeskyFactor`` with
factorize, factorize_whiten, nlml_terms (the materialized K, or the
lazy-gram loop with ``col_fn``), factorize_safe (jitter escalation), the
solves, the log-determinant, the inverse pieces behind fast
cross-validation (ops/nlml.py), the serving-mode explicit inverse and a
prediction's explained variance by one forward substitution (on the
whitening kernel for CUDA f32 factors, ops/whiten.py); the
``DirectInverse`` and ``ExplainedCovariance`` representations;
``truncated_psd_solve`` and ``vertical_stack``.  Above n = 2048 the
factorization is the blocked column-panel loop; at or below it
torch.linalg.cholesky plus triangular solves.  ``factorize_safe`` always
takes the library Cholesky, as the JAX package does.  With
``config.CHOLESKY_PRECISION = "double_word"`` the factorization above
n = 2048 carries its trailing matrix in double word
(ops/compensated.py blocked_cholesky_dw).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..utils.profiling import named_scope
from .blocked_cholesky import blocked_cholesky_cols, blocked_cholesky_cols_fused, cholesky
from .compensated import accurate_sum_of_logs, blocked_cholesky_dw
from .nlml import blocked_lauum, tri_inverse_full
from .whiten import plain_explained_variance, whiten_sumsq

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


def _on_whiten_kernel(L: torch.Tensor, cross: torch.Tensor) -> bool:
    """Whether ``explained_variance`` runs on the whitening kernel
    (ops/whiten.py): a contiguous CUDA f32 factor of n above the blocked
    threshold with n a multiple of 128, a CUDA f32 (n, m) cross covariance
    with m > 0 on its device, and no gradient asked of either (the kernel
    has no backward).  CPU tensors, f64, other shapes and differentiated
    predictions take the plain form."""
    n = L.shape[0]
    return (L.is_cuda and L.dtype == torch.float32 and L.is_contiguous() and n > _BLOCKED_MIN_N and n % 128 == 0
            and cross.ndim == 2 and cross.shape[1] > 0 and cross.dtype == L.dtype and cross.device == L.device
            and not (torch.is_grad_enabled() and (L.requires_grad or cross.requires_grad)))


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
        from .. import config

        K = _prepare(K, jitter, assume_symmetric)
        if K.shape[0] > _BLOCKED_MIN_N:
            if config.cholesky_precision() == "double_word":
                return blocked_cholesky_dw(K, rhs=rhs)
            return blocked_cholesky_cols(K, rhs=rhs)
        with named_scope("albatross.cholesky"):
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
    def nlml_terms(cls, K, rhs, jitter: float = 0.0, assume_symmetric: bool = False, col_fn=None):
        """(log|K|, L^-1 rhs) without assembling the factor at scale.

        ``col_fn(j0, b)`` (optional) builds the active rows j0..n of column
        panel [j0, j0 + b), every diagonal term included: the lazy-gram loop
        (blocked_cholesky_cols_fused) then factors without any (n, n)
        matrix, and ``K`` and ``jitter`` are ignored."""
        from .. import config

        if rhs.ndim != 1:
            raise ValueError(f"nlml_terms expects a 1-D rhs, got shape {tuple(rhs.shape)}")
        double_word = config.cholesky_precision() == "double_word"
        if col_fn is not None:
            if double_word:
                raise ValueError(
                    "nlml_terms(col_fn=...) is incompatible with CHOLESKY_PRECISION='double_word' "
                    "(the double-word carry needs the materialized matrix); pass K instead"
                )
            config.cholesky_algorithm()  # "left" raises
            diag, white = blocked_cholesky_cols_fused(col_fn, rhs.shape[0], rhs=rhs, assemble=False)
            return _sum_of_logs(diag), white
        K = _prepare(K, jitter, assume_symmetric)
        rhs = rhs.to(K.dtype)
        if K.shape[0] > _BLOCKED_MIN_N:
            factor = blocked_cholesky_dw if double_word else blocked_cholesky_cols
            diag, white = factor(K, rhs=rhs, assemble=False)
            return _sum_of_logs(diag), white
        with named_scope("albatross.cholesky"):
            L = cholesky(K)
            white = _lower_solve(L, rhs)
        return _sum_of_logs(torch.diagonal(L)), white

    @staticmethod
    def safe_jitter(K, initial_jitter: float = 0.0, max_tries: int = 6,
                    jitter_growth: float = 100.0) -> float:
        """The jitter ``factorize_safe`` adds to sym(K): 0 (or
        ``initial_jitter``) when that factors, else the first of base,
        base * growth, ... (``max_tries`` of them) that does, else the last.
        The base is ``initial_jitter`` or, when that is 0, the dtype's eps,
        as in the JAX package.  Each try reads the factorization's ``info``
        back to the host (torch.linalg.cholesky raises where the JAX
        package's returns NaN, so tries go through cholesky_ex)."""
        K = 0.5 * (K.detach() + K.detach().T)
        eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
        base = initial_jitter if initial_jitter > 0 else float(torch.finfo(K.dtype).eps)
        tries = [initial_jitter if initial_jitter > 0 else 0.0]
        for _ in range(max_tries):
            tries.append(base)
            base *= jitter_growth
        for i, jitter in enumerate(tries):
            if i > 0 and jitter == tries[i - 1]:
                continue  # the same matrix again (a positive initial jitter is also the base)
            _, info = torch.linalg.cholesky_ex(K + jitter * eye if jitter else K)
            if int(info) == 0:
                break
        return jitter

    @classmethod
    def factorize_safe(cls, K, initial_jitter: float = 0.0, max_tries: int = 6,
                       jitter_growth: float = 100.0) -> "CholeskyFactor":
        """Factorize sym(K) with automatic jitter escalation: the tries run
        without gradients (``safe_jitter``), then one differentiable
        factorization at the chosen jitter carries the gradients.  A matrix
        that no try factors gives a NaN factor, as in the JAX package."""
        jitter = cls.safe_jitter(K, initial_jitter, max_tries, jitter_growth)
        K = 0.5 * (K + K.T)
        if jitter:
            K = K + jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
        return cls(cholesky(K))

    @property
    def shape(self):
        return self.L.shape

    @property
    def dtype(self):
        return self.L.dtype

    @named_scope("albatross.solve")
    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """A^-1 rhs via two triangular solves."""
        rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
        y = torch.linalg.solve_triangular(self.L, rhs2d, upper=False)
        x = torch.linalg.solve_triangular(self.L.T, y, upper=True)
        return x if rhs.ndim > 1 else x[:, 0]

    @named_scope("albatross.solve")
    def sqrt_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """L^-1 rhs -- the whitening transform."""
        return _lower_solve(self.L, rhs)

    @named_scope("albatross.solve")
    def sqrt_transpose_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """L^-T rhs."""
        rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
        y = torch.linalg.solve_triangular(self.L.T, rhs2d, upper=True)
        return y if rhs.ndim > 1 else y[:, 0]

    @named_scope("albatross.solve")
    def explained_variance(self, cross: torch.Tensor) -> torch.Tensor:
        """diag(cross^T A^-1 cross) = ||L^-1 cross[:, j]||^2 for each column
        j of the (n, m) ``cross``: one forward substitution and its column
        sums of squares, under ``albatross.solve.whiten``; on the whitening
        kernel where ``_on_whiten_kernel`` says so (L's diagonal blocks and
        their inverses computed on every call, inside that span), else the
        plain form."""
        with named_scope("albatross.solve.whiten"):
            if _on_whiten_kernel(self.L, cross):
                return whiten_sumsq(self.L, cross)
            return plain_explained_variance(self.L, cross)

    def sqrt_product(self, rhs: torch.Tensor) -> torch.Tensor:
        """L^T rhs."""
        return self.L.T @ rhs

    def matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        """A rhs = L L^T rhs."""
        return self.L @ (self.L.T @ rhs)

    def log_determinant(self) -> torch.Tensor:
        return _sum_of_logs(torch.diagonal(self.L))

    def is_positive_definite(self) -> torch.Tensor:
        d = torch.diagonal(self.L)
        return torch.all(torch.isfinite(d)) & torch.all(d > 0)

    @named_scope("albatross.cholesky.inverse")
    def _tri_inverse(self) -> torch.Tensor:
        """L^-1, GEMM-composed above n = 2048 (ops/nlml.py)."""
        return tri_inverse_full(self.L)

    def inverse(self) -> torch.Tensor:
        """A^-1 = L^-T L^-1 (potri: blocked triangular inverse, then the
        triangularity-exploiting product)."""
        return blocked_lauum(self._tri_inverse())

    def to_direct_inverse(self, refine_steps: int = 2) -> "DirectInverse":
        """Serving-mode representation: one O(n^3) explicit inverse up
        front, then every solve is one GEMM instead of two triangular
        solves.

        ``refine_steps`` Newton-Schulz steps X <- X + X (I - A X) polish the
        inverse, with full-f32 products (the JAX package asks for its
        highest matmul precision; ``config`` keeps TF32 off here).  A step
        is taken only while max|I - A X| < 1, where it contracts; outside
        that basin the unrefined inverse is kept instead of diverging.  The
        gate is a ``torch.where``, so nothing is read back.  Five n x n
        buffers are alive at the peak of a step."""
        X = self.inverse()
        if refine_steps:
            A = self.L @ self.L.T
            for _ in range(refine_steps):
                R = A @ X
                R.neg_()
                R.diagonal().add_(1.0)  # R = I - A X, without an identity buffer
                low, high = torch.aminmax(R)
                contracting = torch.maximum(-low, high) < 1.0
                XR = X @ R
                del R
                X = torch.where(contracting, XR.add_(X), X)
                del XR
            X = 0.5 * (X + X.T)
        return DirectInverse(X)

    def inverse_diagonal(self) -> torch.Tensor:
        """diag(A^-1): the column-wise squared norms of L^-1."""
        Linv = self._tri_inverse()
        return torch.sum(Linv * Linv, dim=0)

    def inverse_blocks(self, indices: Sequence) -> list:
        """The diagonal blocks (A^-1)_gg of each index group: one L^-1, then
        a gather and a small gram per group."""
        Linv = self._tri_inverse()
        blocks = []
        for idx in indices:
            cols = Linv[:, torch.as_tensor(idx, device=Linv.device)]
            blocks.append(cols.T @ cols)
        return blocks


class ExplainedBySolve:
    """``explained_variance`` of a covariance representation that has no
    cheaper form than its ``solve``: diag(cross^T A^-1 cross) as the column
    sums of solve(cross) o cross."""

    def explained_variance(self, cross: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.solve(cross) * cross, dim=0)


@dataclasses.dataclass(frozen=True)
class DirectInverse(ExplainedBySolve):
    """A covariance held by its explicit inverse: solve is one product."""

    inverse_matrix: torch.Tensor

    @named_scope("albatross.solve")
    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.inverse_matrix @ rhs


@dataclasses.dataclass(frozen=True)
class ExplainedCovariance(ExplainedBySolve):
    """C = K (K - P)^-1 K, the covariance ``fit_from_prediction`` rebuilds
    from a prediction P: ``explained`` holds K - P, so solve(rhs) =
    C^-1 rhs = K^-1 (K - P) K^-1 rhs.  Each solve factorizes the prior K
    again, without jitter, as the JAX package does."""

    prior: torch.Tensor  # K
    explained: torch.Tensor  # K - P

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        K_chol = CholeskyFactor.factorize(self.prior)
        return K_chol.solve(self.explained @ K_chol.solve(rhs))


def truncated_psd_solve(A: torch.Tensor, rhs: torch.Tensor, rtol: float = 1e-12) -> torch.Tensor:
    """Solve through the eigendecomposition of sym(A), dropping eigenvalues
    at or below ``rtol`` times the largest magnitude."""
    vals, vecs = torch.linalg.eigh(0.5 * (A + A.T))
    cutoff = rtol * torch.max(torch.abs(vals))
    keep = vals > cutoff
    inv_vals = torch.where(keep, 1.0 / torch.where(keep, vals, torch.ones_like(vals)), torch.zeros_like(vals))
    if rhs.ndim > 1:
        return vecs @ (inv_vals[:, None] * (vecs.T @ rhs))
    return vecs @ (inv_vals * (vecs.T @ rhs))


def vertical_stack(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack matrices row-wise, or concatenate vectors."""
    blocks = [torch.as_tensor(b) for b in blocks]
    if blocks and all(b.ndim == 1 for b in blocks):
        return torch.cat(blocks, dim=0)
    return torch.cat([torch.atleast_2d(b) for b in blocks], dim=0)
