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

``blocked_cholesky_cols_fused`` runs the same loop over lazy column
panels: ``col_fn(j0, b)`` builds each panel's active rows (the gram kernel
writes them straight into the buffer the loop then updates in place), so
no (n, n) matrix exists at any point.

Gradients: autograd differentiates the loop; each diagonal panel's factor
and inverse come from one ``torch.autograd.Function`` with a closed-form
backward (ops/panel_cholinv.py), on every device.

``_cols_core`` and ``padded_column_panels`` also take panels with a
leading batch dimension, forward only: ops/batched_nlml.py factors the
ensemble sampler's (W, n, n) stacks through them, a (W, b, b) stack of
diagonal panels a step.
"""

from __future__ import annotations

import torch

from ..utils.profiling import named_scope

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


def default_block_size(n: int, device: torch.device, dtype: torch.dtype | None = None) -> int:
    """``config.CHOLESKY_BLOCK_SIZE`` when it is set, checked (a multiple of
    128; on CUDA f32 at most MAX_CUDA_PANEL, the panel kernel's bound);
    else ``cuda_block_size`` on CUDA and ``auto_block_size`` elsewhere."""
    from .. import config

    b = config.CHOLESKY_BLOCK_SIZE
    if b is None:
        return cuda_block_size(n) if device.type == "cuda" else auto_block_size(n)
    if b <= 0 or b % 128 != 0:
        raise ValueError(f"config.CHOLESKY_BLOCK_SIZE must be a positive multiple of 128, got {b}")
    if device.type == "cuda" and dtype == torch.float32 and b > MAX_CUDA_PANEL:
        raise ValueError(f"config.CHOLESKY_BLOCK_SIZE = {b} exceeds the CUDA panel kernel's bound "
                         f"MAX_CUDA_PANEL = {MAX_CUDA_PANEL} for f32")
    return b


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """torch.linalg.cholesky with the JAX package's failure semantics: a
    matrix that is not positive definite gives an all-NaN factor (which
    surfaces downstream) instead of an exception; batched over leading
    dimensions, matrix by matrix."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _tri_solve_identity(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def blocked_tri_inverse(L: torch.Tensor, sub: int = DEFAULT_PANEL_SUB) -> torch.Tensor:
    """Inverse of a lower-triangular matrix (or of each of a stack of
    them, over leading dimensions), GEMM-rich: the diagonal sub-blocks are
    inverted by one batched triangular solve, then row block r of W is
    W[r, :r] = -W_rr @ (L[r, :r] @ W[:r, :r]).

    W grows by whole row blocks (the JAX package's ``_compose_inverse_rows``)
    and is never written in place, so autograd can differentiate it: each
    product keeps the rows it read."""
    m = L.shape[-1]
    if m <= sub or m % sub != 0:
        return _tri_solve_identity(L)
    S = m // sub
    diag = torch.stack([L[..., i * sub:(i + 1) * sub, i * sub:(i + 1) * sub] for i in range(S)], dim=-3)
    winv = _tri_solve_identity(diag)
    W = winv[..., 0, :, :]  # the (r0, r0) leading block built so far
    for r in range(1, S):
        r0 = r * sub
        wr = winv[..., r, :, :]
        left = -(wr @ (L[..., r0:r0 + sub, :r0] @ W))
        W = torch.cat([torch.cat([W, W.new_zeros((*W.shape[:-2], r0, sub))], dim=-1),
                       torch.cat([left, wr], dim=-1)], dim=-2)
    return W


@named_scope("albatross.cholesky.panel")
def _panel_chol_inverse(Akk: torch.Tensor, sub: int = DEFAULT_PANEL_SUB):
    """(L, L^-1) of a diagonal panel through the panel Function
    (ops/panel_cholinv.py): its forward is the CUDA panel kernel for CUDA
    f32 tensors, torch.linalg.cholesky + blocked_tri_inverse (the JAX
    package's default panel path) for f64 CUDA tensors and for CPU tensors;
    its backward is the closed form on every device.  A (W, b, b) stack of
    panels (forward only) goes through the batched kernel for CUDA f32 and
    the plain version otherwise."""
    from .panel_cholinv import panel_cholinv_batched, panel_cholinv_function, plain_panel_cholinv

    if Akk.ndim == 2:
        U, Wu = panel_cholinv_function(Akk, sub)
    elif Akk.is_cuda and Akk.dtype == torch.float32:
        U, Wu = panel_cholinv_batched(Akk.contiguous())
    else:
        U, Wu = plain_panel_cholinv(Akk, sub)
    return U.mT, Wu.mT


@named_scope("albatross.cholesky")
def blocked_cholesky(K: torch.Tensor, block_size: int | None = None, use_inverse: bool = True, rhs=None,
                     panel_sub: int | str | None = "auto"):
    """Lower Cholesky factor (and L^-1 rhs when ``rhs`` is given), in the
    JAX package's argument order.

    A single panel (n <= block size) is factored by torch.linalg.cholesky;
    larger matrices go through the column-panel loop, whose panels give
    their inverse with their factor (the panel kernel on CUDA f32).  On the
    plain panel path ``use_inverse=False`` or ``panel_sub=None`` inverts
    each panel by one exact triangular solve, the reference's solve route;
    ``"auto"`` composes it from ``DEFAULT_PANEL_SUB`` blocks."""
    n = K.shape[0]
    b = block_size if block_size is not None else default_block_size(n, K.device, K.dtype)
    if n > b:
        sub = n if not use_inverse or panel_sub is None else \
            DEFAULT_PANEL_SUB if panel_sub == "auto" else int(panel_sub)
        return blocked_cholesky_cols(K, block_size=b, rhs=rhs, panel_sub=sub)
    L = cholesky(K)
    if rhs is None:
        return L
    return L, torch.linalg.solve_triangular(L, rhs[:, None], upper=False)[:, 0]


@named_scope("albatross.cholesky")
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
    b = block_size if block_size is not None else default_block_size(n, K.device, K.dtype)
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
    cols = list(_ColumnPanels.apply(K, b))
    return _cols_core(cols, n, b, rhs, panel_sub=panel_sub, assemble=assemble)


@named_scope("albatross.cholesky")
def blocked_cholesky_cols_fused(
    col_fn,
    n: int,
    rhs: torch.Tensor | None = None,
    block_size: int | None = None,
    panel_sub: int = DEFAULT_PANEL_SUB,
    assemble: bool = True,
    device: torch.device | str | None = None,
):
    """``blocked_cholesky_cols`` over lazy column panels: ``col_fn(j0, b)``
    returns the active rows j0..n of column panel [j0, j0 + b) of the SPD
    matrix, diagonal terms included, as a fresh tensor: the loop updates
    it in place.  Returns what blocked_cholesky_cols returns; the block
    size follows ``rhs``'s device (or ``device``).

    A block size that does not divide n pads lazily, as blocked_cholesky_cols
    pads K: each panel gets zero rows below row n, and the last panel an
    identity block on its padded diagonal.  n <= b factors col_fn(0, n),
    the whole matrix.  The JAX package materializes K in both cases; the
    arithmetic is the same."""
    if not assemble and rhs is None:
        raise ValueError("assemble=False requires rhs (the NLML fused path)")
    if device is None:
        if rhs is None:
            raise ValueError("blocked_cholesky_cols_fused needs rhs or device to pick its block size")
        device = rhs.device
    b = block_size if block_size is not None else default_block_size(
        n, torch.device(device), None if rhs is None else rhs.dtype)
    if n <= b:
        K = col_fn(0, n)
        return blocked_cholesky_cols(K, block_size=b, rhs=None if rhs is None else rhs.to(K.dtype),
                                     panel_sub=panel_sub, assemble=assemble)
    cols = padded_column_panels(col_fn, n, b)
    m = len(cols) * b
    if rhs is not None:
        rhs = torch.nn.functional.pad(rhs.to(cols[0].dtype), (0, m - n))
    out = _cols_core(cols, m, b, rhs, panel_sub=panel_sub, assemble=assemble)
    if m == n:
        return out
    if not assemble:
        diag, z = out
        return diag[:n], z[:n]
    if rhs is None:
        return out[:n, :n]
    L, z = out
    return L[:n, :n], z[:n]


def padded_column_panels(col_fn, n: int, b: int) -> list:
    """Column panels [k0, k0 + b) of an n x n SPD matrix padded to m = n
    rounded up to b, from ``col_fn(k0, bk)``, the rows k0..n of columns
    [k0, k0 + bk) (leading batch dimensions allowed): zero rows n..m below
    each panel, and an identity block on the last panel's padded diagonal,
    so [[K, 0], [0, I]] factors as [[L, 0], [0, I]].  With m > n every
    panel is a fresh tensor; with m == n the panels are col_fn's own."""
    m = -(-n // b) * b
    cols = []
    for k0 in range(0, m, b):
        bk = min(b, n - k0)
        col = col_fn(k0, bk)  # (..., n - k0, bk)
        if m > n:
            col = torch.nn.functional.pad(col, (0, b - bk, 0, m - n))
            if bk < b:  # the last panel: [[K_kk, 0], [0, I]]
                col[..., bk:, bk:] = torch.eye(b - bk, dtype=col.dtype, device=col.device)
        cols.append(col)
    return cols


class _ColumnPanels(torch.autograd.Function):
    """The active rows k*b..n of each column panel k of K, as private
    contiguous copies: the trailing updates subtract in place on these
    copies (inside the GEMM) instead of allocating a new panel and a product
    temporary per update.  The backward writes every panel's gradient into
    one (n, n) buffer; autograd's own slice backward would allocate and add
    an (n, n) buffer per panel."""

    @staticmethod
    def forward(ctx, K, b):
        ctx.n, ctx.b = K.shape[0], b
        return tuple(
            K[k * b:, k * b:(k + 1) * b].clone(memory_format=torch.contiguous_format)
            for k in range(K.shape[0] // b)
        )

    @staticmethod
    @named_scope("albatross.cholesky")
    def backward(ctx, *grads):
        n, b = ctx.n, ctx.b
        gK = next(g for g in grads if g is not None).new_zeros((n, n))
        for k, g in enumerate(grads):
            if g is not None:
                gK[k * b:, k * b:(k + 1) * b] = g
        return gK, None


class _TrailingUpdate(torch.autograd.Function):
    """cols[j] -= B[r0:] B[r0:r0+b]^T in place for each later panel j (r0 =
    (j - k - 1) b), where B holds the rows of column panel k below its
    diagonal block.  The backward accumulates B's gradient in one buffer,
    inside the GEMMs; autograd of the sliced ``addmm_`` would allocate and
    add a buffer of B's shape for each slice."""

    @staticmethod
    def forward(ctx, B, *cols):
        _trailing_update(B, cols)
        ctx.mark_dirty(*cols)
        ctx.save_for_backward(B)
        return cols

    @staticmethod
    @named_scope("albatross.cholesky.trailing")
    def backward(ctx, *grads):
        (B,) = ctx.saved_tensors
        b = B.shape[1]
        gB = torch.zeros_like(B)
        for i, G in enumerate(grads):
            if G is not None:
                r0 = i * b
                gB[r0:].addmm_(G, B[r0:r0 + b], alpha=-1.0)
                gB[r0:r0 + b].addmm_(G.T, B[r0:], alpha=-1.0)
        return (gB, *grads)


@named_scope("albatross.cholesky.trailing")
def _trailing_update(B, cols) -> None:
    """cols[i] -= B[i b:] B[i b:(i + 1) b]^T in place, inside the GEMM;
    over leading batch dimensions too (``baddbmm_``)."""
    b = B.shape[-1]
    for i, C in enumerate(cols):
        lhs, rhs = B[..., i * b:, :], B[..., i * b:(i + 1) * b, :].mT
        if B.ndim == 2:
            C.addmm_(lhs, rhs, alpha=-1.0)
        else:
            C.baddbmm_(lhs, rhs, alpha=-1.0)


def _matvec(M, v):
    """M @ v over leading batch dimensions; a plain matrix-vector product
    for one matrix."""
    return M @ v if v.ndim == 1 else (M @ v[..., None])[..., 0]


def _cols_core(cols, n: int, b: int, rhs, *, panel_sub: int, assemble: bool):
    """The right-looking loop over active-row column panels.

    Autograd differentiates it: the whitened vector is built from per-panel
    pieces (an in-place write would change rows an earlier product saved),
    while the trailing updates stay in place on the column panels, private
    copies of K or the gram kernel's outputs (``_TrailingUpdate`` saves its
    factor B, never the matrices it updates).  Without ``assemble`` a panel
    is dropped from ``cols`` once factored, so without autograd only the
    panels still to factor stay alive."""
    G = n // b
    tail = rhs  # rows k0.. of the partly whitened right-hand side
    white, diags = [], []
    for k in range(G):
        col = cols[k]  # (..., n - k0, b)
        Lkk, W = _panel_chol_inverse(col[..., :b, :], panel_sub)
        with named_scope("albatross.cholesky.panel_solve"):
            below = col[..., b:, :] @ W.mT  # (..., n - k0 - b, b)
        if assemble:
            cols[k] = torch.cat([Lkk, below], dim=-2)
        else:
            cols[k] = col = None
            diags.append(torch.diagonal(Lkk, dim1=-2, dim2=-1))
        if tail is not None:
            with named_scope("albatross.cholesky.whiten"):
                zk = _matvec(W, tail[..., :b])
                white.append(zk)
                tail = tail[..., b:] - _matvec(below, zk)
        if k + 1 < G:
            if below.requires_grad:
                cols[k + 1:] = _TrailingUpdate.apply(below, *cols[k + 1:])
            else:
                _trailing_update(below, cols[k + 1:])
    z = None if rhs is None else torch.cat(white, dim=-1)
    if not assemble:
        return torch.cat(diags, dim=-1), z
    L = cols[0].new_zeros((*cols[0].shape[:-2], n, n))
    for k in range(G):
        L[..., k * b:, k * b:(k + 1) * b] = cols[k]
    return L if rhs is None else (L, z)
