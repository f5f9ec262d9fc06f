"""Right-looking blocked Cholesky over column panels.

Counterpart of the main-path part of ``albatross_tpu.ops.blocked_cholesky``:

    for each panel k:
        (L_kk, W) = chol + inverse of the diagonal panel  (_panel_chol_inverse)
        L_pk      = A_pk @ W^T                             (GEMM)
        A_trail  -= L_pk @ L_pk^T, panel by panel           (GEMMs)

with optional fused whitening z = L^-1 rhs (the panel inverses double as
forward substitution) and ``assemble=False``, which returns only
(diag(L), z) -- all the NLML needs.

For CUDA tensors the block size is ``cuda_block_size`` (b <= 1024, the
panel kernel's bound) at every dtype; CPU tensors keep the JAX package's
``auto_block_size`` so the parity tests block the same way.  The panel
route is chosen by dtype before any launch: a CUDA f32 panel goes through
the hand-written panel kernel (ops/panel_cholinv.py), which launches or
raises; a CUDA f64 panel takes torch.linalg.cholesky + blocked_tri_inverse,
the JAX package's default panel path.  The TPU kernel is f32-only (it
casts its input to f32) and the JAX package never sends an f64 panel to
it, so neither does the port.  The panel solve and the trailing updates
are plain large GEMMs (``torch.matmul``), as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import torch

DEFAULT_BLOCK = 1024
# sub-block of the GEMM-composed panel inverse (blocked_tri_inverse)
DEFAULT_PANEL_SUB = 256
# largest panel the CUDA panel kernel takes
MAX_CUDA_PANEL = 1024


def auto_block_size(n: int, max_panels: int = 16) -> int:
    """The JAX package's panel size: the smallest 128-aligned divisor of n
    that is >= 1792 with at most ``max_panels`` panels, else
    ceil(max(1024, n/8)) rounded up to 128."""
    for g in range(max_panels, 1, -1):
        if n % g != 0:
            continue
        b = n // g
        if b >= 1792 and b % 128 == 0:
            return b
    b = max(DEFAULT_BLOCK, -(-n // 8))
    return -(-b // 128) * 128


def cuda_block_size(n: int) -> int:
    """Panel size on CUDA: the largest multiple of 128 that is <= 1024 and
    divides n, else 1024 (the factorization then pads with identity)."""
    for b in range(MAX_CUDA_PANEL, 127, -128):
        if n % b == 0:
            return b
    return MAX_CUDA_PANEL


def default_block_size(n: int, device: torch.device) -> int:
    return cuda_block_size(n) if device.type == "cuda" else auto_block_size(n)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """torch.linalg.cholesky with the JAX package's failure semantics: a
    matrix that is not positive definite gives an all-NaN factor (which
    surfaces downstream) instead of an exception."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _tri_solve_identity(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def blocked_tri_inverse(L: torch.Tensor, sub: int = DEFAULT_PANEL_SUB) -> torch.Tensor:
    """Inverse of a lower-triangular matrix, GEMM-rich: the diagonal
    sub-blocks are inverted by one batched triangular solve, then row block
    r of W is W[r, :r] = -W_rr @ (L[r, :r] @ W[:r, :r])."""
    m = L.shape[0]
    if m <= sub or m % sub != 0:
        return _tri_solve_identity(L)
    S = m // sub
    diag = torch.stack([L[i * sub:(i + 1) * sub, i * sub:(i + 1) * sub] for i in range(S)])
    winv = _tri_solve_identity(diag)
    W = torch.zeros_like(L)  # filled row block by row block below
    W[:sub, :sub] = winv[0]
    for r in range(1, S):
        r0 = r * sub
        W[r0:r0 + sub, :r0] = -(winv[r] @ (L[r0:r0 + sub, :r0] @ W[:r0, :r0]))
        W[r0:r0 + sub, r0:r0 + sub] = winv[r]
    return W


def _panel_chol_inverse(Akk: torch.Tensor, sub: int = DEFAULT_PANEL_SUB):
    """(L, L^-1) of a diagonal panel: the CUDA panel kernel for CUDA
    tensors other than f64, torch.linalg.cholesky + blocked_tri_inverse
    (the JAX package's default panel path) for f64 CUDA tensors and for CPU
    tensors."""
    if Akk.is_cuda and Akk.dtype != torch.float64:
        from .panel_cholinv import panel_cholinv

        U, Wu = panel_cholinv(Akk)
        return U.T, Wu.T
    L = cholesky(Akk)
    return L, blocked_tri_inverse(L, sub)


def blocked_cholesky(K: torch.Tensor, block_size: int | None = None, rhs=None):
    """Lower Cholesky factor (and L^-1 rhs when ``rhs`` is given).

    A single panel (n <= block size) is factored by torch.linalg.cholesky;
    larger matrices go through the column-panel loop."""
    n = K.shape[0]
    b = block_size if block_size is not None else default_block_size(n, K.device)
    if n > b:
        return blocked_cholesky_cols(K, block_size=b, rhs=rhs)
    L = cholesky(K)
    if rhs is None:
        return L
    return L, torch.linalg.solve_triangular(L, rhs[:, None], upper=False)[:, 0]


def blocked_cholesky_cols(
    K: torch.Tensor,
    block_size: int | None = None,
    rhs: torch.Tensor | None = None,
    panel_sub: int = DEFAULT_PANEL_SUB,
    assemble: bool = True,
):
    """Column-panel blocked Cholesky.

    Returns L, or (L, z) with ``rhs`` where z = L^-1 rhs.  ``assemble=False``
    (requires ``rhs``) never builds the (n, n) factor and returns
    (diag(L), z).  n that the block size does not divide is padded with an
    identity block: [[K, 0], [0, I]] factors as [[L, 0], [0, I]]."""
    n = K.shape[0]
    if not assemble and rhs is None:
        raise ValueError("assemble=False requires rhs (the NLML fused path)")
    b = block_size if block_size is not None else default_block_size(n, K.device)
    if n <= b:
        out = blocked_cholesky(K, b, rhs=rhs)
        if not assemble:
            L, z = out
            return torch.diagonal(L), z
        return out
    if n % b != 0:
        m = -(-n // b) * b
        Kp = torch.zeros((m, m), dtype=K.dtype, device=K.device)
        Kp[:n, :n] = K
        idx = torch.arange(n, m, device=K.device)
        Kp[idx, idx] = 1.0
        rp = None if rhs is None else torch.cat([rhs, rhs.new_zeros(m - n)])
        out = blocked_cholesky_cols(Kp, block_size=b, rhs=rp, panel_sub=panel_sub,
                                    assemble=assemble)
        if not assemble:
            diag, z = out
            return diag[:n], z[:n]
        if rhs is None:
            return out[:n, :n]
        L, z = out
        return L[:n, :n], z[:n]
    # Each entry holds only the active rows k*b..n of column panel k, as a
    # private contiguous copy: the trailing updates subtract in place on
    # these copies (inside the GEMM) instead of allocating a new panel and a
    # product temporary per update.
    cols = [
        K[k * b:, k * b:(k + 1) * b].clone(memory_format=torch.contiguous_format)
        for k in range(n // b)
    ]
    return _cols_core(cols, n, b, rhs, panel_sub=panel_sub, assemble=assemble)


def _cols_core(cols, n: int, b: int, rhs, *, panel_sub: int, assemble: bool):
    """The right-looking loop over active-row column panels."""
    G = n // b
    z = None if rhs is None else rhs.clone()  # whitened in place
    for k in range(G):
        k0 = k * b
        col = cols[k]  # (n - k0, b)
        Lkk, W = _panel_chol_inverse(col[:b], panel_sub)
        below = col[b:] @ W.T  # (n - k0 - b, b)
        cols[k] = torch.cat([Lkk, below], dim=0)
        if z is not None:
            zk = W @ z[k0:k0 + b]
            z[k0:k0 + b] = zk
            z[k0 + b:] -= below @ zk
        for j in range(k + 1, G):
            j0 = j * b
            Lj = below[j0 - k0 - b:j0 - k0]  # (b, b): panel rows of j
            Lrows = below[j0 - k0 - b:]  # rows j0.. of column k
            cols[j].addmm_(Lrows, Lj.T, alpha=-1.0)  # C -= A B^T in the GEMM
    if not assemble:
        diag = torch.cat([torch.diagonal(cols[k][:b]) for k in range(G)])
        return diag, z
    L = torch.zeros((n, n), dtype=cols[0].dtype, device=cols[0].device)
    for k in range(G):
        L[k * b:, k * b:(k + 1) * b] = cols[k]
    return L if rhs is None else (L, z)
