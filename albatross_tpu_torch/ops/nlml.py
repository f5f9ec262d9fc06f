"""GEMM-composed explicit inverses from a Cholesky factor (LAPACK potri).

Counterpart of ``albatross_tpu.ops.nlml``, with its block structure:

    W    = L^-1   two-level blocked triangular inverse (tri_inverse_full)
    K^-1 = W^T W  exploiting W's triangularity, n^3/3 FLOPs in S GEMMs
                  instead of a dense n^3 product (blocked_lauum)

They power ``CholeskyFactor.inverse / inverse_diagonal / inverse_blocks``,
the engine of fast LOO / LOGO cross-validation.  Nothing is written in
place, so autograd differentiates them.
"""

from __future__ import annotations

import torch

from .blocked_cholesky import _tri_solve_identity, blocked_tri_inverse

_BLOCK_CANDIDATES = (2560, 2048, 1536, 1280, 1024, 512, 256, 128)
_PAD_BLOCK = 512
# at or below this n: one triangular solve, one dense product
_DENSE_MAX_N = 2048


def _pick_block(n: int) -> int | None:
    for b in _BLOCK_CANDIDATES:
        if n % b == 0 and n > b:
            return b
    return None


def _pad_identity_tail(T: torch.Tensor, npad: int) -> torch.Tensor:
    """blockdiag(T, I_{npad - n}): trtri and lauum both factor through it,
    so padded results slice back exactly."""
    n = T.shape[0]
    return torch.block_diag(T, torch.eye(npad - n, dtype=T.dtype, device=T.device))


def tri_inverse_full(L: torch.Tensor) -> torch.Tensor:
    """W = L^-1 for a full-size lower-triangular factor, GEMM-rich: coarse
    row blocks whose diagonal inverses are themselves GEMM-composed
    (blocked_tri_inverse); n that no candidate block divides is padded with
    an identity tail to a multiple of 512."""
    n = L.shape[0]
    if n <= _DENSE_MAX_N:
        return _tri_solve_identity(L)
    b = _pick_block(n)
    if b is None:
        npad = -(-n // _PAD_BLOCK) * _PAD_BLOCK
        return tri_inverse_full(_pad_identity_tail(L, npad))[:n, :n]
    S = n // b
    diag = [L[i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(S)]
    if b % 512 == 0 and b > 512:
        winv = [blocked_tri_inverse(Li, 512) for Li in diag]
    else:
        winv = list(_tri_solve_identity(torch.stack(diag)))
    W = winv[0]  # the (r0, r0) leading block built so far
    for r in range(1, S):
        r0 = r * b
        left = -(winv[r] @ (L[r0:r0 + b, :r0] @ W))
        W = torch.cat([torch.cat([W, W.new_zeros((r0, b))], dim=1),
                       torch.cat([left, winv[r]], dim=1)], dim=0)
    return W


def blocked_lauum(W: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """W^T W for lower-triangular W (LAPACK lauum): row strip i of the lower
    triangle is one GEMM, M[i, :i+1] = W[i:, i]^T W[i:, :i+1], and the upper
    triangle its mirror."""
    n = W.shape[0]
    if n <= _DENSE_MAX_N:
        return W.T @ W
    b = block if block is not None else _pick_block(n)
    if b is None:
        npad = -(-n // _PAD_BLOCK) * _PAD_BLOCK
        return blocked_lauum(_pad_identity_tail(W, npad))[:n, :n]
    M = W.new_zeros((n, n))
    for i0 in range(0, n, b):
        strip = W[i0:, i0:i0 + b].T @ W[i0:, :i0 + b]  # (b, i0 + b): blocks j <= i of row i
        M[i0:i0 + b, :i0 + b] = strip
        M[:i0, i0:i0 + b] = strip[:, :i0].T
    return M


def spd_inverse_from_factor(L: torch.Tensor) -> torch.Tensor:
    """K^-1 = W^T W from the Cholesky factor (potri: trtri + lauum)."""
    return blocked_lauum(tri_inverse_full(L))
