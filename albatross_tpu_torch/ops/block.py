"""Block-structured solvers.

Counterpart of ``albatross_tpu.ops.block``.  ``BlockDiagonal`` stacks its
blocks into one (G, b, b) tensor, identity-padded to a shared size, so the
factorization is one batched Cholesky (cuSOLVER's batched potrf on the
card, as the JAX package uses XLA's batched Cholesky) and the solves are
batched triangular solves.  ``DiagonalCholesky`` is the all-singleton case
(FITC).  ``BlockSymmetric`` is the Schur-complement 2 x 2 solve behind
incremental GP updates.

The true block sizes stay on the host as a list of ints, read once: they
shape every split and gather, and a tensor of them on the card would cost a
device sync per group (the JAX package reads its sizes back inside each
loop).  A dense right-hand side is split into padded (G, b, m) chunks by one
gather with a host-built index, and joined back by another.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Sequence

import numpy as np
import torch

from ..utils.profiling import named_scope
from .blocked_cholesky import cholesky
from .compensated import accurate_sum_of_logs
from .linalg import ExplainedBySolve


def pad_blocks(blocks: Sequence[torch.Tensor]):
    """Stack ragged SPD blocks into (G, b_max, b_max), identity-padding;
    returns (stacked, sizes) with ``sizes`` a host list."""
    sizes = [int(b.shape[0]) for b in blocks]
    b_max = max(sizes)
    padded = [b if b.shape[0] == b_max
              else torch.block_diag(b, torch.eye(b_max - b.shape[0], dtype=b.dtype, device=b.device))
              for b in blocks]
    return torch.stack(padded), sizes


class _Layout:
    """Row indices between a dense (n, m) right-hand side and its padded
    (G, b, m) chunks, built once on the host from the block sizes and moved
    to each device once."""

    def __init__(self, sizes: List[int], b: int):
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        n = int(offsets[-1])
        gather = np.full((len(sizes), b), n, dtype=np.int64)  # row n: the zero row
        valid = np.zeros((len(sizes), b), dtype=bool)
        for g, k in enumerate(sizes):
            gather[g, :k] = np.arange(offsets[g], offsets[g] + k)
            valid[g, :k] = True
        self.G, self.b, self.n = len(sizes), b, n
        self._host = {"gather": torch.from_numpy(gather.reshape(-1)),
                      "valid": torch.from_numpy(np.flatnonzero(valid)),
                      "mask": torch.from_numpy(valid)}
        self._on = {}

    def get(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        if key not in self._on:
            self._on[key] = self._host[name].to(device)
        return self._on[key]

    def split_pad(self, rhs: torch.Tensor) -> torch.Tensor:
        """Dense (n, ...) rhs -> padded (G, b, ...) chunks, zero rows in the
        pad."""
        ext = torch.cat([rhs, rhs.new_zeros((1,) + tuple(rhs.shape[1:]))])
        return ext[self.get("gather", rhs.device)].reshape((self.G, self.b) + tuple(rhs.shape[1:]))

    def unsplit(self, chunks: torch.Tensor) -> torch.Tensor:
        flat = chunks.reshape((-1,) + tuple(chunks.shape[2:]))
        return flat[self.get("valid", chunks.device)]


@dataclasses.dataclass(frozen=True)
class BlockDiagonal:
    """Block-diagonal matrix as a stacked (G, b, b) tensor."""

    blocks: torch.Tensor  # (G, b, b), identity-padded
    sizes: List[int]  # true block sizes, on the host

    @classmethod
    def from_blocks(cls, blocks: Sequence[torch.Tensor]) -> "BlockDiagonal":
        return cls(*pad_blocks(blocks))

    @functools.cached_property
    def _layout(self) -> _Layout:
        return _Layout(self.sizes, self.blocks.shape[1])

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def rows(self) -> int:
        return sum(self.sizes)

    def diagonal(self) -> torch.Tensor:
        """The blocks' diagonals, concatenated."""
        return self._layout.unsplit(torch.diagonal(self.blocks, dim1=1, dim2=2))

    def matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        rhs2 = rhs if rhs.ndim > 1 else rhs[:, None]
        out = self._layout.unsplit(self.blocks @ self._layout.split_pad(rhs2))
        return out if rhs.ndim > 1 else out[:, 0]

    def __matmul__(self, rhs):
        return self.matmul(rhs)

    def to_dense(self) -> torch.Tensor:
        return torch.block_diag(*[self.blocks[g, :k, :k] for g, k in enumerate(self.sizes)])

    def factorize(self) -> "BlockDiagonalCholesky":
        return BlockDiagonalCholesky(cholesky(self.blocks), self.sizes)


@dataclasses.dataclass(frozen=True)
class BlockDiagonalCholesky:
    """Per-block Cholesky factors from one batched factorization; a block
    that is not positive definite gives NaN, as in the JAX package."""

    L: torch.Tensor  # (G, b, b), identity in the padding
    sizes: List[int]

    @functools.cached_property
    def _layout(self) -> _Layout:
        return _Layout(self.sizes, self.L.shape[1])

    @property
    def rows(self) -> int:
        return sum(self.sizes)

    @named_scope("albatross.solve")
    def _batched_solve(self, rhs: torch.Tensor, transpose: bool) -> torch.Tensor:
        rhs2 = rhs if rhs.ndim > 1 else rhs[:, None]
        chunks = self._layout.split_pad(rhs2)
        if transpose:
            out = torch.linalg.solve_triangular(self.L.mT, chunks, upper=True)
        else:
            out = torch.linalg.solve_triangular(self.L, chunks, upper=False)
        dense = self._layout.unsplit(out)
        return dense if rhs.ndim > 1 else dense[:, 0]

    def sqrt_solve(self, rhs):
        """L^-1 rhs, block by block."""
        return self._batched_solve(rhs, transpose=False)

    def sqrt_transpose_solve(self, rhs):
        return self._batched_solve(rhs, transpose=True)

    def solve(self, rhs):
        return self.sqrt_transpose_solve(self.sqrt_solve(rhs))

    def log_determinant(self) -> torch.Tensor:
        diags = torch.diagonal(self.L, dim1=1, dim2=2)
        return 2.0 * accurate_sum_of_logs(diags, where=self._layout.get("mask", self.L.device))

    def l1_norm(self) -> float:
        """||A||_1 of the factorized matrix, the largest absolute column
        sum: for a block-diagonal matrix, the largest over the blocks.  The
        padding is left out.  Reads the value back to the host."""
        A = self.L @ self.L.mT
        valid = self._layout.get("mask", self.L.device)
        A = torch.where(valid[:, :, None] & valid[:, None, :], A, torch.zeros_like(A))
        col_sums = torch.sum(torch.abs(A), dim=1)  # (G, b)
        return float(torch.max(torch.where(valid, col_sums, torch.full_like(col_sums, -torch.inf))))

    def rcond(self, max_iterations: int = 5) -> float:
        """Reciprocal L1 condition estimate 1 / (||A||_1 est ||A^-1||_1),
        with Hager's one-norm estimator driven by block solves (Higham
        Alg. 2.4): the estimate is kept monotone, the loop stops when it
        stops increasing, and zero entries of y take sign +1.  Each
        iteration reads values back to the host."""
        n = self.rows
        x = torch.full((n,), 1.0 / n, dtype=self.L.dtype, device=self.L.device)
        est = 0.0
        for _ in range(max_iterations):
            y = self.solve(x)
            new_est = float(torch.sum(torch.abs(y)))
            if new_est <= est:
                break
            est = new_est
            xi = torch.where(y >= 0, 1.0, -1.0).to(y.dtype)
            z = self.solve(xi)  # A symmetric: the transposed solve is the solve
            if float(torch.max(torch.abs(z))) <= float(z @ x):
                break
            x = torch.zeros_like(x)
            x[int(torch.argmax(torch.abs(z)))] = 1.0
        denom = self.l1_norm() * est
        return float("inf") if denom == 0.0 else 1.0 / denom


@dataclasses.dataclass(frozen=True)
class DiagonalCholesky:
    """All blocks singletons (FITC): A = diag(d); every solve is an
    elementwise divide."""

    sqrt_diag: torch.Tensor  # (n,)

    @property
    def rows(self) -> int:
        return self.sqrt_diag.shape[0]

    @named_scope("albatross.solve")
    def _div(self, rhs):
        return rhs / (self.sqrt_diag[:, None] if rhs.ndim > 1 else self.sqrt_diag)

    def sqrt_solve(self, rhs):
        return self._div(rhs)

    def sqrt_transpose_solve(self, rhs):
        return self._div(rhs)

    def solve(self, rhs):
        return self._div(self._div(rhs))

    def log_determinant(self) -> torch.Tensor:
        return 2.0 * accurate_sum_of_logs(self.sqrt_diag)


@dataclasses.dataclass(frozen=True)
class BlockSymmetric(ExplainedBySolve):
    """M = [A B; B^T C] through A's factorization, Ai_B = A^-1 B and the
    factorized Schur complement S = C - B^T A^-1 B: a training covariance
    grown without refactorizing its old block."""

    A: Any  # any object with .solve / .log_determinant
    Ai_B: torch.Tensor
    S: Any  # factorization of the Schur complement

    @property
    def rows(self) -> int:
        return self.Ai_B.shape[0] + self.Ai_B.shape[1]

    @named_scope("albatross.solve")
    def solve(self, rhs):
        rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
        n_a = self.Ai_B.shape[0]
        x, y = rhs2d[:n_a], rhs2d[n_a:]
        v = self.S.solve(y - self.Ai_B.T @ x)
        u = self.A.solve(x) - self.Ai_B @ v
        out = torch.cat([u, v], dim=0)
        return out if rhs.ndim > 1 else out[:, 0]

    def log_determinant(self):
        return self.A.log_determinant() + self.S.log_determinant()


def build_block_symmetric(A, B: torch.Tensor, S_chol) -> BlockSymmetric:
    """From A's factorization, the cross block B and the factorized Schur
    complement (the GP update passes the predicted joint covariance plus the
    new target variance, which is C - B^T A^-1 B)."""
    return BlockSymmetric(A, A.solve(B), S_chol)


def build_block_symmetric_from_C(A, B: torch.Tensor, C: torch.Tensor) -> BlockSymmetric:
    """From the raw lower-right block C: S = C - B^T A^-1 B is computed and
    factorized here."""
    from .linalg import CholeskyFactor

    Ai_B = A.solve(B)
    return BlockSymmetric(A, Ai_B, CholeskyFactor.factorize(C - B.T @ Ai_B))


# -- grouped block utilities -------------------------------------------------
def block_sum(blocks):
    """Sum of same-shaped blocks (Grouped values or a sequence)."""
    values = blocks.values() if hasattr(blocks, "values") else list(blocks)
    out = values[0]
    for v in values[1:]:
        out = out + v
    return out


def block_accumulate(lhs, rhs, apply_function):
    """sum over keys of apply_function(lhs[key], rhs[key])."""
    keys = lhs.keys()
    if len(keys) != len(rhs.keys()) or not keys:
        raise ValueError("block_accumulate needs two non-empty groupings with the same keys")
    return block_sum([apply_function(lhs[k], rhs[k]) for k in keys])


def block_product(lhs, rhs):
    """[x_0 ... x_n] @ [y_0; ...; y_n] over aligned group keys."""
    return block_accumulate(lhs, rhs, lambda x, y: x @ y)


def block_inner_product(lhs, rhs):
    """[x_0^T ... x_n^T] @ [y_0; ...; y_n] over aligned group keys."""
    return block_accumulate(lhs, rhs, lambda x, y: x.T @ y)


def block_diag_solve(solvers, rhs):
    """solvers[key].solve(rhs[key]) for each group."""
    return rhs.apply(lambda key, value: solvers[key].solve(value))


def block_subtract(lhs, rhs):
    return rhs.apply(lambda key, value: lhs[key] - value)
