"""2-D tile-sharded Cholesky and solves: O(N^2/(R C)) matrix bytes a rank.

Counterpart of ``albatross_tpu.parallel.cholesky2d``.  The N x N SPD
matrix is tiled over a 2-D (R rows x C columns) mesh: rank (i, j) owns
only its (N/R, N/C) tile, a DTensor with ``Shard(0)`` on the row axis and
``Shard(1)`` on the column axis at the API boundary; inside, each function
works on ``to_local()`` tiles with the explicit collectives of ``_comm``
over the row group and the column group, as a ``shard_map`` body does.

Factorization (right-looking, panel width p dividing the tile width):

    for each panel k:
      1. the column of ranks owning panel k contributes its rows: one sum
         over the column group and one gather over the row group assemble
         the whole (N, p) panel on every rank;
      2. every rank factors the p x p diagonal block and forms its inverse
         (the panel kernel on CUDA f32, as the 1-D layout's diagonal
         blocks), and the panel of L as one GEMM against it;
      3. each rank applies the rank-p trailing update to its whole tile
         (finished panels see zero rows of L, as in the JAX package).

Solves walk q-blocks (q = gcd(br, bc), so each diagonal q-block lives on
one rank) with one reduction a step; with ``W_SOLVE_MIN_RHS`` or more
right-hand sides ``auto`` routes them through the tile-sharded W = L^-1
(R rounds, then two GEMMs a triangle).  The inverse diagonal and blocks
(fast LOO / LOGO) reuse W.

Right-hand sides are replicated plain tensors; every result other than
the factor and W (solutions, log-determinants, inverse diagonals and
blocks) comes back replicated, so the single-process prediction and
cross-validation code takes it as it is.  Gradients: ``_comm`` says how a
replicated loss's gradient reaches every rank whole; ``vary`` stands where
the JAX package's varying-axes inference puts ``pvary``.  While autograd
records, ownership masks are ``torch.where`` over both branches, so every
rank's graph, and so its backward collectives, are the same; without it
they are plain branches and the trailing update runs in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..ops.compensated import accurate_sum_of_logs
from ..ops.nlml import tri_inverse_full
from ._comm import Axis, all_reduce_sum, gather_cols, gather_rows, mesh_axis, vary
from .cholesky import _factor_block
from .gram import _tile_placements, as_tiles, tile_shape

# Right-hand-side count from which ``auto`` solves through W = L^-1: R
# collective rounds and two GEMMs instead of N/q substitution rounds.
W_SOLVE_MIN_RHS = 32


def _default_panel(bc: int) -> int:
    if bc <= 1024:
        return bc
    for p in (1024, 512, 256, 128):
        if bc % p == 0:
            return p
    return bc


def _tracking(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _sel(cond: bool, a: torch.Tensor, b, graph: bool) -> torch.Tensor:
    """``a`` if cond else ``b`` (a tensor or 0): a plain branch, or while
    autograd records (``graph``) a ``torch.where`` that keeps both."""
    if not graph:
        return a if cond else (b if isinstance(b, torch.Tensor) else torch.zeros_like(a))
    return torch.where(torch.tensor(cond, device=a.device), a, b)


def _axes(mesh, row_axis: str, col_axis: str):
    return mesh_axis(mesh, row_axis), mesh_axis(mesh, col_axis)


def _local_tile(A, mesh, row_axis, col_axis, rax: Axis, cax: Axis) -> torch.Tensor:
    """This rank's tile of a tile-sharded DTensor, or of a replicated
    DTensor or plain tensor (which enters through ``vary``)."""
    br, bc = tile_shape(A.shape[0], rax, cax)
    if isinstance(A, DTensor):
        if tuple(A.placements) == _tile_placements(mesh, row_axis, col_axis):
            return A.to_local()
        if not all(p.is_replicate() for p in A.placements):
            raise ValueError(f"expected tiles over ({row_axis!r}, {col_axis!r}) or a replicated tensor, "
                             f"got {A.placements}")
        A = A.to_local()
    i, j = rax.rank, cax.rank
    return vary(A, (rax, cax))[i * br:(i + 1) * br, j * bc:(j + 1) * bc]


def _chol2d_local(A: torch.Tensor, rax: Axis, cax: Axis, p: int) -> torch.Tensor:
    br, bc = A.shape
    n = br * rax.size
    i, j = rax.rank, cax.rank
    both = (rax, cax)
    graph = _tracking(A)
    if not graph:
        A = A.clone(memory_format=torch.contiguous_format)
    rows = torch.arange(n, device=A.device)[:, None]
    for k in range(n // p):
        j_k = (k * p) // bc
        o_c = k * p - j_k * bc
        # 1. assemble panel k: the owning column of ranks contributes its rows
        contrib = _sel(j == j_k, A[:, o_c:o_c + p], 0.0, graph)
        col_full = gather_rows(all_reduce_sum(contrib, cax), rax, br)  # (n, p), the same on every rank
        # 2. diagonal factor and its inverse (every rank), the panel of L
        L_kk, W = _factor_block(col_full[k * p:(k + 1) * p], need_inverse=True)
        panel = vary(col_full @ W.T, both)
        L_below = torch.where(rows >= (k + 1) * p, panel, 0.0)
        L_col = torch.cat([L_below[:k * p], vary(L_kk, both), L_below[(k + 1) * p:]])
        mine = L_col[i * br:(i + 1) * br]  # this rank's rows of the finished panel
        Lr, Lc = L_below[i * br:(i + 1) * br], L_below[j * bc:(j + 1) * bc]
        # 3. write the panel into the owner's tile, trailing update of the
        # whole tile (finished rows and columns of L_below are zero)
        if graph:
            A = _sel(j == j_k, A.slice_scatter(mine, dim=1, start=o_c, end=o_c + p), A, graph)
            A = A - Lr @ Lc.T
        else:
            if j == j_k:
                A[:, o_c:o_c + p] = mine
            A.addmm_(Lr, Lc.T, alpha=-1.0)
    return torch.tril(A, diagonal=i * br - j * bc)  # zero the strict upper triangle


def distributed_cholesky_2d(A, mesh, row_axis: str = "data", col_axis: str = "model",
                            panel: int | None = None) -> DTensor:
    """Cholesky of an SPD matrix tiled over a 2-D mesh (a tile-sharded
    DTensor, or a matrix every rank holds whole).  N must divide both axis
    sizes and the panel width the tile width.  Returns L (lower), tiled the
    same way: no rank holds more than N^2/(R C) matrix entries plus one
    (N, panel) transient."""
    rax, cax = _axes(mesh, row_axis, col_axis)
    br, bc = tile_shape(A.shape[0], rax, cax)
    p = panel if panel is not None else _default_panel(bc)
    if bc % p != 0:
        raise ValueError(f"panel={p} must divide the tile width {bc}")
    A_local = _local_tile(A, mesh, row_axis, col_axis, rax, cax)
    return as_tiles(_chol2d_local(A_local, rax, cax, p), mesh, row_axis, col_axis)


def _factor_tile(L, mesh, row_axis, col_axis):
    rax, cax = _axes(mesh, row_axis, col_axis)
    if not isinstance(L, DTensor) or tuple(L.placements) != _tile_placements(mesh, row_axis, col_axis):
        raise ValueError(f"the factor must be a DTensor tiled over ({row_axis!r}, {col_axis!r})")
    return L.to_local(), rax, cax


def _forward_sub_2d(L_local, rhs_local, rax: Axis, cax: Axis):
    """L x = rhs over q-blocks with sharded state: the owning row of ranks
    sums its accumulators over the column group, the owner of the diagonal
    q-block solves it, a reduction over both groups broadcasts it, and
    each rank whose tile holds its columns folds it into its accumulator.
    Returns this rank's (br, m) rows of x."""
    br, bc = L_local.shape
    q = math.gcd(br, bc)
    i, j = rax.rank, cax.rank
    both = (rax, cax)
    graph = _tracking(L_local, rhs_local)
    eye = torch.eye(q, dtype=L_local.dtype, device=L_local.device)
    x_local = torch.zeros_like(rhs_local)
    acc = torch.zeros_like(rhs_local)
    for k in range(br * rax.size // q):
        i_k, j_k = (k * q) // br, (k * q) // bc
        o_r, o_c = k * q - i_k * br, k * q - j_k * bc
        owner = i == i_k and j == j_k
        acc_k = all_reduce_sum(_sel(i == i_k, acc[o_r:o_r + q], 0.0, graph), cax)
        num = vary(rhs_local[o_r:o_r + q] - acc_k, cax)
        L_kk = _sel(owner, L_local[o_r:o_r + q, o_c:o_c + q], eye, graph)  # identity keeps the backward finite
        x_k = torch.linalg.solve_triangular(L_kk, num, upper=False)
        x_k = vary(all_reduce_sum(_sel(owner, x_k, 0.0, graph), both), rax)
        x_local = _sel(i == i_k, x_local.slice_scatter(x_k, dim=0, start=o_r, end=o_r + q), x_local, graph)
        if graph or j == j_k:
            acc = acc + _sel(j == j_k, L_local[:, o_c:o_c + q], 0.0, graph) @ vary(x_k, cax)
    return x_local


def _back_sub_2d(L_local, rhs_local, rax: Axis, cax: Axis):
    """L^T x = rhs over q-blocks, last to first: (L^T x)_k sums the
    products of L's block column k (down the owning column of ranks) with
    the solved rows in one reduction over both groups."""
    br, bc = L_local.shape
    q = math.gcd(br, bc)
    i, j = rax.rank, cax.rank
    both = (rax, cax)
    graph = _tracking(L_local, rhs_local)
    eye = torch.eye(q, dtype=L_local.dtype, device=L_local.device)
    x_local = torch.zeros_like(rhs_local)
    steps = br * rax.size // q
    for s in range(steps):
        k = steps - 1 - s
        i_k, j_k = (k * q) // br, (k * q) // bc
        o_r, o_c = k * q - i_k * br, k * q - j_k * bc
        owner = i == i_k and j == j_k
        Lcol = _sel(j == j_k, L_local[:, o_c:o_c + q], 0.0, graph)
        total = all_reduce_sum(Lcol.T @ vary(x_local, cax), both)
        num = vary(rhs_local[o_r:o_r + q] - vary(total, rax), cax)
        L_kk = _sel(owner, L_local[o_r:o_r + q, o_c:o_c + q], eye, graph)
        x_k = torch.linalg.solve_triangular(L_kk.T, num, upper=True)
        x_k = vary(all_reduce_sum(_sel(owner, x_k, 0.0, graph), both), rax)
        x_local = _sel(i == i_k, x_local.slice_scatter(x_k, dim=0, start=o_r, end=o_r + q), x_local, graph)
    return x_local


def _tri_inverse_2d_local(L_local: torch.Tensor, rax: Axis, cax: Axis) -> torch.Tensor:
    """This rank's tile of W = L^-1 in R rounds of the blocked recursion
    W[r, :] = -W_rr (sum_{d<r} L[r, d-block] W[d, :]), W_rr = L_rr^-1:
    round r broadcasts row block r of L (one reduction over the row group,
    one gather over the column group), every earlier row of ranks
    contracts its slice against its own tile of W, and one reduction hands
    row r the total."""
    br, bc = L_local.shape
    R = rax.size
    i, j = rax.rank, cax.rank
    graph = _tracking(L_local)
    dev = L_local.device
    # this row of ranks' diagonal block L_ii, from the tiles of the row
    src = i * br + torch.arange(br, device=dev) - j * bc
    part = torch.where(((src >= 0) & (src < bc))[None, :], L_local[:, src.clamp(0, bc - 1)], 0.0)
    Wd = vary(tri_inverse_full(all_reduce_sum(part, cax)), cax)  # (br, br), W_ii
    dst = j * bc + torch.arange(bc, device=dev) - i * br
    W_local = torch.where(((dst >= 0) & (dst < br))[None, :], Wd[:, dst.clamp(0, br - 1)], 0.0)
    for r in range(1, R):
        Lr = gather_cols(all_reduce_sum(_sel(i == r, L_local, 0.0, graph), rax), cax)  # (br, n): row block r
        Lri = vary(vary(Lr, rax)[:, i * br:(i + 1) * br], cax)
        contrib = _sel(i < r, Lri @ W_local, 0.0, graph) if graph or i < r else torch.zeros_like(W_local)
        total = vary(all_reduce_sum(contrib, rax), rax)
        # row r: the off-diagonal blocks; total is zero at and right of the
        # diagonal block, so the W_rr already there stays
        if graph or i == r:
            W_local = _sel(i == r, W_local - Wd @ total, W_local, graph)
    return W_local


def distributed_tri_inverse_2d(L, mesh, row_axis: str = "data", col_axis: str = "model") -> DTensor:
    """W = L^-1 with both L and W tiled over the 2-D mesh."""
    tile_shape(L.shape[0], *_axes(mesh, row_axis, col_axis))
    L_local, rax, cax = _factor_tile(L, mesh, row_axis, col_axis)
    return as_tiles(_tri_inverse_2d_local(L_local, rax, cax), mesh, row_axis, col_axis)


def _wapply(W_local, rhs_local, rax: Axis, cax: Axis):
    """y = W rhs, W tiled, rhs and y row-sharded: one gather of rhs over
    the row group, one (br x bc x m) GEMM, one reduction over the column
    group."""
    bc = W_local.shape[1]
    j = cax.rank
    full = gather_rows(rhs_local, rax, rhs_local.shape[0])
    seg = vary(vary(full, cax)[j * bc:(j + 1) * bc], rax)
    return all_reduce_sum(W_local @ seg, cax)


def _wapply_transpose(W_local, y_local, rax: Axis, cax: Axis):
    """z = W^T y, W tiled, y and z row-sharded: one GEMM and a reduction
    down the column of ranks, then the block-column result resharded to
    rows (each global row lies in one block column, so the masked parts
    sum exactly)."""
    br, bc = W_local.shape
    i, j = rax.rank, cax.rank
    z_col = vary(all_reduce_sum(W_local.T @ vary(y_local, cax), rax), rax)  # (bc, m), block column j
    src = i * br + torch.arange(br, device=W_local.device) - j * bc
    part = torch.where(((src >= 0) & (src < bc))[:, None], z_col[src.clamp(0, bc - 1)], 0.0)
    return all_reduce_sum(part, cax)


def _solve_2d(L, rhs, mesh, row_axis, col_axis, *, both: bool, mode: str):
    """L^-1 rhs (both=False) or (L L^T)^-1 rhs (both=True), replicated.

    mode: ``auto`` routes W_SOLVE_MIN_RHS or more right-hand sides through
    the tile-sharded W (R rounds whatever q is) and fewer through the
    q-block substitution (no n^3 inverse for one vector); ``substitution``
    and ``inverse`` force a route."""
    L_local, rax, cax = _factor_tile(L, mesh, row_axis, col_axis)
    if mode not in ("auto", "substitution", "inverse"):
        raise ValueError(f"mode must be 'auto', 'substitution' or 'inverse', not {mode!r}")
    br = L_local.shape[0]
    vec = rhs.ndim == 1
    rhs2 = (rhs[:, None] if vec else rhs).to(device=L_local.device, dtype=L_local.dtype)
    use_w = rhs2.shape[1] >= W_SOLVE_MIN_RHS if mode == "auto" else mode == "inverse"
    rhs_local = vary(rhs2, rax)[rax.rank * br:(rax.rank + 1) * br]
    if use_w:
        W_local = _tri_inverse_2d_local(L_local, rax, cax)
        x = _wapply(W_local, rhs_local, rax, cax)
        if both:
            x = _wapply_transpose(W_local, x, rax, cax)
    else:
        x = _forward_sub_2d(L_local, rhs_local, rax, cax)
        if both:
            x = _back_sub_2d(L_local, x, rax, cax)
    out = gather_rows(x, rax, br)
    return out[:, 0] if vec else out


def distributed_sqrt_solve_2d(L, rhs, mesh, row_axis: str = "data", col_axis: str = "model",
                              mode: str = "auto") -> torch.Tensor:
    """L^-1 rhs with L tiled; rhs (N,) or (N, m), replicated.  Returns the
    whitened rhs, replicated."""
    return _solve_2d(L, rhs, mesh, row_axis, col_axis, both=False, mode=mode)


def distributed_solve_2d(L, rhs, mesh, row_axis: str = "data", col_axis: str = "model",
                         mode: str = "auto") -> torch.Tensor:
    """(L L^T)^-1 rhs through both triangles (many right-hand sides: W once,
    then W^T W rhs as two GEMM applications); replicated."""
    return _solve_2d(L, rhs, mesh, row_axis, col_axis, both=True, mode=mode)


def distributed_log_determinant_2d(L, mesh, row_axis: str = "data", col_axis: str = "model") -> torch.Tensor:
    """2 sum(log diag(L)) with L tiled: each rank sums the logs of the
    stretch of the global diagonal that crosses its tile; replicated."""
    L_local, rax, cax = _factor_tile(L, mesh, row_axis, col_axis)
    br, bc = L_local.shape
    diag = torch.diagonal(L_local, offset=rax.rank * br - cax.rank * bc)
    return all_reduce_sum(2.0 * accurate_sum_of_logs(diag), (rax, cax))


def distributed_inverse_diagonal_2d(L, mesh, row_axis: str = "data", col_axis: str = "model") -> torch.Tensor:
    """diag(A^-1) with A = L L^T, L tiled: the squared column norms of the
    tile-sharded W = L^-1 (R rounds, then one reduction over the row
    group), gathered over the column group; replicated."""
    L_local, rax, cax = _factor_tile(L, mesh, row_axis, col_axis)
    W_local = _tri_inverse_2d_local(L_local, rax, cax)
    cols = all_reduce_sum(torch.sum(W_local * W_local, dim=0), rax)  # (bc,), this block column's
    return gather_rows(cols, cax, cols.shape[0])


def distributed_inverse_blocks_2d(L, indices_groups, mesh, row_axis: str = "data",
                                  col_axis: str = "model") -> list:
    """The diagonal blocks (A^-1)_gg of each index group from the tiled
    factor (fast LOGO): W = L^-1 is built once, and per group the block is
    (W S_g)^T (W S_g) with this tile's columns of the selection, one
    reduction over each group; the groups of each size in one batched
    product.  Replicated."""
    L_local, rax, cax = _factor_tile(L, mesh, row_axis, col_axis)
    W_local = _tri_inverse_2d_local(L_local, rax, cax)
    bc = W_local.shape[1]
    c0 = cax.rank * bc
    out = [None] * len(indices_groups)
    for size in sorted({int(np.asarray(idx).shape[0]) for idx in indices_groups}):
        members = [g for g, idx in enumerate(indices_groups) if np.asarray(idx).shape[0] == size]
        local = torch.as_tensor(np.stack([np.asarray(indices_groups[g]) for g in members]),
                                device=W_local.device) - c0
        owned = (local >= 0) & (local < bc)
        cols = torch.where(owned, W_local[:, local.clamp(0, bc - 1)], 0.0)  # (br, groups, size)
        cols = all_reduce_sum(cols, cax)  # W[my rows, idx]
        blocks = all_reduce_sum(torch.einsum("bgm,bgk->gmk", cols, cols), rax)
        for g, member in enumerate(members):
            out[member] = blocks[g]
    return out
