"""A marginal prediction's explained variance on the tensor cores: the CUDA
kernel, its plain version and the kernel's arithmetic in plain PyTorch.

For the lower Cholesky factor L of the training covariance A (n, n) and
the cross covariance k (n, m), the explained variance of each prediction is

    diag(k^T A^-1 k)_j = ||L^-1 k[:, j]||^2,

the column sums of squares of one forward substitution.  The two
triangular solves of A^-1 k, the product with k and its column sum are
not needed.

``plain_explained_variance`` is one ``solve_triangular`` and the sums of
squares, on any device and dtype.  ``csrc/whiten_sumsq.cu`` computes the
same in 3xTF32 by a blocked forward substitution over row panels of
b = ``cuda_block_size(n)``: on a working copy of k, each row panel is
multiplied by the inverse W_k of L's diagonal block L_kk
(``diagonal_blocks``), refined once by the residual of L_kk and its sums
of squares taken, then the rows below it are updated with L's panel below
the diagonal block; no solution exists as a whole (the source's header
says more).  ``split_explained_variance`` is that loop in plain PyTorch,
each product split into TF32 parts as the kernel's (ops/trailing_update.py
``tf32_split``); the CPU tests and chip_smoke.py hold the kernel against
it and against f64.  ``whiten_sumsq`` launches the kernel, 4 n / b - 1
launches a call (``_build.LAUNCHES["whiten_sumsq"]``), for CUDA f32
tensors whose n is a multiple of 128, and raises on anything else;
ops/linalg.py ``CholeskyFactor.explained_variance`` routes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .blocked_cholesky import cuda_block_size
from .trailing_update import _split_product

_T = 128


def plain_explained_variance(L: torch.Tensor, cross: torch.Tensor) -> torch.Tensor:
    """||L^-1 cross[:, j]||^2 for every column j: one triangular solve, then
    the column sums of squares."""
    white = torch.linalg.solve_triangular(L, cross, upper=False)
    return torch.sum(white * white, dim=0)


def diagonal_blocks(L: torch.Tensor, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(D, W), each (n / b, b, b): L's diagonal blocks of size b with zeros
    above their diagonals, and their inverses by one batched triangular
    solve; both row-major (the library's solve may return column-major)."""
    n = L.shape[0]
    L = L.contiguous()
    D = L.as_strided((n // b, b, b), (b * (n + 1), n, 1)).tril()
    eye = torch.eye(b, dtype=L.dtype, device=L.device).expand(n // b, b, b)
    return D, torch.linalg.solve_triangular(D, eye, upper=False).contiguous()


def split_explained_variance(L: torch.Tensor, cross: torch.Tensor, b: int) -> torch.Tensor:
    """The kernel's loop in plain PyTorch: panel by panel of b rows of C, a
    copy of ``cross``, X0^T = C[panel]^T W_k^T, the residual C[panel] -=
    L_kk X0, X^T = X0^T + C[panel]^T W_k^T and its row sums of squares, then
    C[below] -= L[below, panel] X, each product in 3xTF32 with f32 matmuls;
    the sums kept by tiles of 128 columns of X^T and added at the end."""
    n, m = cross.shape
    D, W = diagonal_blocks(L, b)
    C = cross.clone()
    part = cross.new_zeros((b // _T, m))
    for k in range(n // b):
        panel = C[k * b:(k + 1) * b]
        X0t = _split_product(panel.T, W[k].T)
        panel -= _split_product(D[k], X0t.T)
        Xt = X0t + _split_product(panel.T, W[k].T)
        part += (Xt * Xt).view(m, b // _T, _T).sum(-1).T
        if (k + 1) * b < n:
            C[(k + 1) * b:] -= _split_product(L[(k + 1) * b:, k * b:(k + 1) * b], Xt.T)
    return part.sum(0)


def whiten_sumsq(L: torch.Tensor, cross: torch.Tensor) -> torch.Tensor:
    """||L^-1 cross[:, j]||^2 for every column j on the kernel: L (n, n)
    contiguous, cross (n, m), both CUDA f32, n a multiple of 128, else it
    raises.  L's diagonal blocks and their inverses (``diagonal_blocks``)
    are computed on every call.  The caller's tensors are not written."""
    for name, t in (("L", L), ("cross", cross)):
        if t.ndim != 2 or not t.is_cuda or t.dtype != torch.float32:
            raise TypeError(f"the whitening kernel takes CUDA f32 matrices, got {name} of {tuple(t.shape)} "
                            f"{t.dtype} on {t.device}")
    n, m = cross.shape
    if L.shape != (n, n) or n % _T != 0 or m == 0 or L.device != cross.device:
        raise ValueError(f"the whitening kernel needs L of (n, n) and cross of (n, m) on one device with "
                         f"n % 128 == 0 and m > 0, got L of {tuple(L.shape)} on {L.device} and cross of "
                         f"{tuple(cross.shape)} on {cross.device}")
    if not L.is_contiguous():
        raise ValueError("the whitening kernel reads L in place: it needs a contiguous L")
    b = cuda_block_size(n)
    D, W = diagonal_blocks(L, b)
    mp = -(-m // _T) * _T
    C = cross.new_zeros((n, mp)) if mp > m else cross.new_empty((n, m))  # zero columns pad m: their sums are 0
    C[:, :m] = cross
    X = cross.new_empty((mp, b))
    part = cross.new_zeros((b // _T, mp))
    lib = _build.load("whiten_sumsq")
    fn = lib.whiten_sumsq_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int)]
    launches = ctypes.c_int(0)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    code = fn(L.data_ptr(), D.data_ptr(), W.data_ptr(), C.data_ptr(), X.data_ptr(), part.data_ptr(), n, mp, b,
              stream, ctypes.byref(launches))
    _build.count_launch("whiten_sumsq", launches.value)
    _build.check(lib, code, "whiten_sumsq kernel")
    return part.sum(0)[:m]
