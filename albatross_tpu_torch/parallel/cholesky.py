"""Distributed blocked Cholesky and triangular solves, 1-D row layout.

Counterpart of ``albatross_tpu.parallel.cholesky``: the same
right-looking factorization over the ranks of one mesh axis.

* The matrix is row-panel sharded: rank d owns rows [d b, (d + 1) b) of
  the N x N SPD matrix (b = N / ranks), a ``Shard(0)`` DTensor at the API
  boundary; inside, each function works on ``to_local()`` rows with the
  explicit collectives of ``_comm``, as a ``shard_map`` body does.
* Step k gathers the active rows of column panel k (ranks k.. send their
  blocks), factors the b x b diagonal block redundantly on every rank
  through the port's own factorization (``blocked_cholesky``: the panel
  kernel for CUDA f32, never one panel above 1024) and its inverse
  (``blocked_tri_inverse``), forms the panel's rows of L below it, and
  applies the trailing update to this rank's own rows, up to its diagonal
  block.  The last step, and a world of one rank, has no rows below the
  diagonal block: no inverse and no trailing product are formed there.
* The solves are block substitutions with one reduction a panel; the
  triangular inverse behind the inverse diagonal and blocks takes G
  rounds of two reductions.

Right-hand sides are replicated: every rank passes the whole vector or
matrix, as a plain tensor.  Results other than the factor (solutions,
log-determinants, inverse diagonals and blocks) are replicated plain
tensors, equal on every rank, so the single-process prediction and
cross-validation code takes them as they are.  Everything is out of place
and differentiable; ``_comm`` says how the gradient of a replicated loss
reaches every rank whole.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from ..ops.blocked_cholesky import MAX_CUDA_PANEL, _panel_chol_inverse, blocked_cholesky, blocked_tri_inverse
from ..ops.compensated import accurate_sum_of_logs
from ..ops.nlml import tri_inverse_full
from ._comm import Axis, all_reduce_sum, gather_rows, mesh_axis, tie, vary, zeros
from .mesh import row_sharded


def _local_rows(A, mesh, axis: str, ax: Axis) -> torch.Tensor:
    """This rank's (b, ...) rows of a row-sharded DTensor, or of a
    replicated DTensor or plain tensor (which enter through ``vary``)."""
    n = A.shape[0]
    if n % ax.size != 0:
        raise ValueError(f"N={n} not divisible by mesh axis size {ax.size}")
    if isinstance(A, DTensor):
        if tuple(A.placements) == row_sharded(mesh, axis):
            return A.to_local()
        if not all(isinstance(p, Replicate) for p in A.placements):
            raise ValueError(f"expected rows sharded over {axis!r} or a replicated tensor, got {A.placements}")
        A = A.to_local()
    b = n // ax.size
    return vary(A, ax)[ax.rank * b:(ax.rank + 1) * b]


def _factor_block(D: torch.Tensor, need_inverse: bool):
    """(L, L^-1 or None) of a diagonal block: one panel-kernel call when it
    fits a panel, else the blocked loop and the GEMM-composed inverse."""
    b = D.shape[0]
    if need_inverse and b % 128 == 0 and b <= MAX_CUDA_PANEL:
        return _panel_chol_inverse(D.contiguous())
    L = blocked_cholesky(D)
    return L, (blocked_tri_inverse(L) if need_inverse else None)


def _chol_local(A_local: torch.Tensor, ax: Axis) -> torch.Tensor:
    b, n = A_local.shape
    G, d = ax.size, ax.rank
    T = A_local[:, :(d + 1) * b]  # this rank's rows, columns up to its diagonal block
    blocks, unused = [], []
    for k in range(G):
        mine = T[:, :b] if d >= k else A_local[:0, :b]
        col = gather_rows(mine, ax, b, first=k)  # rows k b.. of column panel k
        Lkk, W = _factor_block(col[:b], need_inverse=k < G - 1)
        v = Lkk if k == G - 1 else torch.cat([Lkk, col[b:] @ W.T])  # rows k b.. of column k of L
        v = vary(v, ax)
        if d < k:
            unused.append(v)
            continue
        Lmine = v[(d - k) * b:(d - k + 1) * b]
        blocks.append(Lmine)
        if d > k:
            T = T[:, b:] - Lmine @ v[b:(d - k + 1) * b].T
    if d + 1 < G:
        blocks.append(A_local.new_zeros((b, n - (d + 1) * b)))
    return tie(torch.cat(blocks, dim=1), unused, ax)


def _as_row_sharded(local: torch.Tensor, mesh, axis: str) -> DTensor:
    n = local.shape[0] * mesh_axis(mesh, axis).size
    return DTensor.from_local(local, mesh, row_sharded(mesh, axis), run_check=False,
                              shape=torch.Size((n, *local.shape[1:])), stride=local.stride())


def distributed_cholesky(A, mesh, axis: str = "data") -> DTensor:
    """Cholesky of an SPD matrix row-sharded over ``axis`` (a ``Shard(0)``
    DTensor, or a matrix every rank holds whole).  N must divide the mesh
    axis size.  Returns L (lower), row-sharded the same way."""
    ax = mesh_axis(mesh, axis)
    return _as_row_sharded(_chol_local(_local_rows(A, mesh, axis, ax), ax), mesh, axis)


def _factor_rows(L, mesh, axis: str):
    ax = mesh_axis(mesh, axis)
    if not isinstance(L, DTensor) or tuple(L.placements) != row_sharded(mesh, axis):
        raise ValueError(f"the factor must be a DTensor with rows sharded over {axis!r}")
    return L.to_local(), ax


def _forward_sub_local(L_local, rhs_local, ax: Axis):
    """L x = rhs with row-sharded L and rhs: rank k solves its block, a
    masked reduction broadcasts it, and each later rank folds it into its
    rows' accumulator.  Returns (this rank's rows of x, the broadcasts it
    left unused, for ``tie``)."""
    b = L_local.shape[0]
    G, d = ax.size, ax.rank
    acc = None
    unused = []
    for k in range(G):
        if d == k:
            rest = rhs_local if acc is None else rhs_local - acc
            x_mine = torch.linalg.solve_triangular(L_local[:, k * b:(k + 1) * b], rest, upper=False)
            x_k = x_mine
        else:
            x_k = zeros(rhs_local.shape, rhs_local, (L_local, rhs_local), ax)
        x_k = vary(all_reduce_sum(x_k, ax), ax)
        if d > k:
            term = L_local[:, k * b:(k + 1) * b] @ x_k
            acc = term if acc is None else acc + term
        else:
            unused.append(x_k)
    return x_mine, unused


def _back_sub_local(L_local, rhs_local, ax: Axis):
    """L^T x = rhs with row-sharded L: blocks are solved last to first;
    (L^T x)_k sums each later rank's L[r, k]^T x_r in one reduction.
    Returns what ``_forward_sub_local`` returns."""
    b = L_local.shape[0]
    G, d = ax.size, ax.rank
    unused = []
    x_mine = None
    for k in range(G - 1, -1, -1):
        if d > k:
            contrib = L_local[:, k * b:(k + 1) * b].T @ x_mine
        else:
            contrib = zeros(rhs_local.shape, rhs_local, (L_local, rhs_local), ax)
        total = vary(all_reduce_sum(contrib, ax), ax)
        if d == k:
            x_mine = torch.linalg.solve_triangular(L_local[:, k * b:(k + 1) * b].T, rhs_local - total,
                                                   upper=True)
        else:
            unused.append(total)
    return x_mine, unused


def _rhs_local(rhs, mesh, axis, ax, dtype):
    vec = rhs.ndim == 1
    rhs2 = rhs[:, None] if vec else rhs
    return _local_rows(rhs2.to(dtype), mesh, axis, ax), vec


def distributed_sqrt_solve(L, rhs, mesh, axis: str = "data") -> torch.Tensor:
    """L^-1 rhs with L row-sharded; rhs (N,) or (N, m), replicated.
    Returns the whitened rhs, replicated."""
    L_local, ax = _factor_rows(L, mesh, axis)
    rhs_local, vec = _rhs_local(rhs, mesh, axis, ax, L_local.dtype)
    x, unused = _forward_sub_local(L_local, rhs_local, ax)
    out = tie(gather_rows(x, ax, L_local.shape[0]), unused, ax)
    return out[:, 0] if vec else out


def distributed_solve(L, rhs, mesh, axis: str = "data") -> torch.Tensor:
    """(L L^T)^-1 rhs through both triangles; rhs (N,) or (N, m),
    replicated; the result replicated."""
    L_local, ax = _factor_rows(L, mesh, axis)
    rhs_local, vec = _rhs_local(rhs, mesh, axis, ax, L_local.dtype)
    y, unused = _forward_sub_local(L_local, rhs_local, ax)
    x, unused_back = _back_sub_local(L_local, y, ax)
    out = tie(gather_rows(x, ax, L_local.shape[0]), unused + unused_back, ax)
    return out[:, 0] if vec else out


def distributed_log_determinant(L, mesh, axis: str = "data") -> torch.Tensor:
    """2 sum(log diag(L)) with L row-sharded; replicated."""
    L_local, ax = _factor_rows(L, mesh, axis)
    b = L_local.shape[0]
    diag = torch.diagonal(L_local[:, ax.rank * b:(ax.rank + 1) * b])
    return all_reduce_sum(2.0 * accurate_sum_of_logs(diag), ax)


def _tri_inverse_local(L_local: torch.Tensor, ax: Axis) -> torch.Tensor:
    """This rank's rows of W = L^-1 in G rounds of the blocked recursion
    W[r, :r] = -W_rr (L[r, :r] W[:r, :r]): round r broadcasts rank r's rows
    of L, every earlier rank contracts them against its own rows of W, and
    a reduction hands the sum to rank r."""
    b, n = L_local.shape
    G, d = ax.size, ax.rank
    Wd = tri_inverse_full(L_local[:, d * b:(d + 1) * b])
    left = None  # W[d rows, :d b], set in round d
    unused = []
    for r in range(1, G):
        L_r = L_local[:, :r * b] if d == r else zeros((b, r * b), L_local, (L_local,), ax)
        L_r = vary(all_reduce_sum(L_r, ax), ax)  # rank r's rows of L, columns < r b
        if d < r:
            mine = L_r[:, d * b:(d + 1) * b] @ torch.cat([left, Wd], dim=1) if left is not None \
                else L_r[:, d * b:(d + 1) * b] @ Wd
            contrib = torch.nn.functional.pad(mine, (0, (r - d - 1) * b))
        else:
            unused.append(L_r)
            contrib = zeros((b, r * b), L_local, (L_local,), ax)
        total = vary(all_reduce_sum(contrib, ax), ax)
        if d == r:
            left = -(Wd @ total)
        else:
            unused.append(total)
    parts = ([left] if left is not None else []) + [Wd]
    if d + 1 < G:
        parts.append(L_local.new_zeros((b, n - (d + 1) * b)))
    return tie(torch.cat(parts, dim=1), unused, ax)


def distributed_inverse_diagonal(L, mesh, axis: str = "data") -> torch.Tensor:
    """diag(A^-1) with A = L L^T, L row-sharded: the squared column norms
    of W = L^-1, reduced over the ranks.  Replicated."""
    L_local, ax = _factor_rows(L, mesh, axis)
    W_local = _tri_inverse_local(L_local, ax)
    return all_reduce_sum(torch.sum(W_local * W_local, dim=0), ax)


def distributed_inverse_blocks(L, indices_groups, mesh, axis: str = "data") -> list:
    """The diagonal blocks (A^-1)_gg of each index group from the
    row-sharded factor: one distributed triangular inverse serves every
    group, (A^-1)_gg = sum over ranks of the local column-gather grams; the
    groups of each size in one batched product.  Replicated."""
    L_local, ax = _factor_rows(L, mesh, axis)
    W_local = _tri_inverse_local(L_local, ax)
    out = [None] * len(indices_groups)
    for size in sorted({int(np.asarray(idx).shape[0]) for idx in indices_groups}):
        members = [i for i, idx in enumerate(indices_groups) if np.asarray(idx).shape[0] == size]
        idx_mat = torch.as_tensor(np.stack([np.asarray(indices_groups[i]) for i in members]),
                                  device=W_local.device)
        cols = W_local[:, idx_mat]  # (b, groups, size)
        blocks = all_reduce_sum(torch.einsum("bgm,bgk->gmk", cols, cols), ax)
        for g, i in enumerate(members):
            out[i] = blocks[g]
    return out
