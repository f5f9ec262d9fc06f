"""Double-word (two-float) compensated arithmetic and the NLML accuracy modes.

Counterpart of ``albatross_tpu.ops.compensated``: the error-free
transformations ``two_sum`` and ``two_prod``, double-word sums
(``dw_add``, ``dw_sum``, ``dot2``, ``dw_matvec``), the accurate f32 log
(``accurate_log``, ``accurate_log_guarded``, ``accurate_sum_of_logs``,
``dw_log_determinant``), and the two accuracy modes built from them:

* ``compensated_nll``: the NLML with its quadratic term refined by
  iterative refinement with a double-word residual (``refined_quadratic``)
  and every reduction and the final combination in double word
  (``config.NLML_COMPENSATED``);
* ``blocked_cholesky_dw``: the right-looking blocked Cholesky with the
  trailing matrix carried as an unevaluated (hi, lo) pair, so each panel's
  input is one rounding from exact (``config.CHOLESKY_PRECISION =
  "double_word"``).

In eager PyTorch every operation is its own launch, so a multiply and the
add that follows it never contract into an FMA, and ``two_prod`` stays
error-free without an explicit fma.  A fusing compiler (``torch.compile``,
a TorchScript fuser) would contract them: keep these functions eager.

The JAX package's ``_exact_product_precision`` / ``DW_DOT_ALGORITHM``
choose bf16-limb products on the TPU; every f32 product here is already a
full f32 product (TF32 off, ``config``), so they have no counterpart.
"""

from __future__ import annotations

import math

import torch


def two_sum(a, b):
    """Error-free sum: returns (s, e) with a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def veltkamp_split(a):
    """a = hi + lo with hi, lo representable in half the mantissa."""
    splitter = 134217729.0 if a.dtype == torch.float64 else 4097.0
    c = splitter * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: returns (p, e) with a * b = p + e exactly."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dw_add(xh, xl, yh, yl):
    """Double-word + double-word (the accurate variant)."""
    sh, sl = two_sum(xh, yh)
    th, tl = two_sum(xl, yl)
    c = sl + th
    vh, vl = two_sum(sh, c)
    w = tl + vl
    return two_sum(vh, w)


def dw_sum(hi, lo=None, axis: int = -1, *, dim: int | None = None):
    """Pairwise double-word sum along ``axis`` (``dim`` is torch's name for
    it): (hi, lo) per slice, error O(eps^2), from a log-depth tree of
    vectorized two_sums."""
    if dim is not None:
        axis = dim
    hi = torch.movedim(torch.as_tensor(hi), axis, -1)
    lo = torch.zeros_like(hi) if lo is None else torch.movedim(torch.as_tensor(lo), axis, -1)
    n = hi.shape[-1]
    npad = 1 << max(0, math.ceil(math.log2(n))) if n > 1 else 1
    if npad != n:  # zeros are exact under two_sum
        hi = torch.nn.functional.pad(hi, (0, npad - n))
        lo = torch.nn.functional.pad(lo, (0, npad - n))
        n = npad
    while n > 1:
        half = n // 2
        s, e = two_sum(hi[..., :half], hi[..., half:])
        lo = lo[..., :half] + lo[..., half:] + e
        hi = s
        n = half
    return hi[..., 0], lo[..., 0]


def dot2(x, y):
    """Compensated dot product (Ogita-Rump-Oishi Dot2), as (hi, lo): error
    about eps + cond * eps^2."""
    p, e = two_prod(x, y)
    return dw_sum(p, e)


def dw_matvec(K: torch.Tensor, v: torch.Tensor, chunk: int = 1024):
    """K @ v as (hi, lo) from error-free products and double-word row sums,
    the f32 analog of an f64 mat-vec (error O(eps^2 cond)).  Rows go in
    blocks of ``chunk`` (one block when ``chunk`` does not divide n), so
    the splitting temporaries stay O(chunk n)."""
    n = K.shape[0]
    if n % chunk != 0:
        chunk = n
    hs, ls = [], []
    for r0 in range(0, n, chunk):
        p, e = two_prod(K[r0:r0 + chunk], v[None, :])
        h, l = dw_sum(p, e, axis=1)
        hs.append(h)
        ls.append(l)
    return torch.cat(hs), torch.cat(ls)


LN2_HI = 0.6931471824645996  # float32(ln 2)
LN2_LO = float(math.log(2.0) - LN2_HI)


def _accurate_log_values(x: torch.Tensor):
    x = x.to(torch.float32)
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | (127 << 23)).view(torch.float32)  # [1, 2), exact
    big = m > 1.4142135
    m = torch.where(big, 0.5 * m, m)  # exact (power-of-two scale)
    e = (e + big.to(e.dtype)).to(torch.float32)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    # ln m = 2s (1 + s^2/3 + s^4/5 + s^6/7 + s^8/9 + s^10/11)
    poly = 1.0 + s2 * (
        1.0 / 3.0 + s2 * (0.2 + s2 * (1.0 / 7.0 + s2 * (1.0 / 9.0 + s2 / 11.0)))
    )
    ln_m = (2.0 * s) * poly
    ph, pe = two_prod(e, torch.full_like(e, LN2_HI))
    h, t = two_sum(ph, ln_m)
    return h, t + pe + e * LN2_LO


class _AccurateLog(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _accurate_log_values(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad_h, grad_l):
        (x,) = ctx.saved_tensors
        return grad_h / x.to(torch.float32)

    @staticmethod
    def vmap(info, in_dims, x):
        """torch.func.vmap batches it (cross-validation scores every fold in
        one vmap).  The forward is elementwise, so it runs on the batched
        tensor as it stands; a generated rule would need a batching rule
        for ``Tensor.view(dtype)``, which torch 2.11 lacks (the scores then
        fell back to one fold at a time)."""
        return _AccurateLog.apply(x), (in_dims[0], in_dims[0])


def accurate_log(x: torch.Tensor):
    """f32 natural log as a double word (hi, lo), with sub-ulp error.

    x = 2^e m with m in [sqrt(1/2), sqrt(2)) by an exact bitwise reduction,
    ln m = 2 atanh((m - 1)/(m + 1)) by its series, and e ln 2 carried in
    double word.  Positive finite normal inputs only; d log x = dx / x."""
    return _AccurateLog.apply(x)


def _log_validity(x: torch.Tensor) -> torch.Tensor:
    """Where accurate_log's bitwise reduction is meaningful: positive
    finite normal values."""
    return torch.isfinite(x) & (x >= torch.finfo(x.dtype).tiny)


def accurate_log_guarded(x: torch.Tensor):
    """accurate_log with the builtin log's domain semantics: 0 -> -inf,
    negative -> NaN, NaN -> NaN, inf -> inf, subnormal -> the builtin's
    value, so a failed factorization still surfaces."""
    x = x.to(torch.float32)
    h, l = accurate_log(x)
    valid = _log_validity(x)
    return torch.where(valid, h, torch.log(x)), torch.where(valid, l, torch.zeros_like(l))


def _guarded_log_terms(flat: torch.Tensor):
    """Split sum(log) over the last axis of ``flat`` into a double-word part
    over the valid (positive finite normal) entries and a plain sum of
    builtin logs over the others, which keeps exact -inf / NaN
    propagation."""
    f32 = flat.dtype == torch.float32
    valid = _log_validity(flat)
    safe = torch.where(valid, flat, torch.ones_like(flat))
    if f32:
        h, l = accurate_log(safe)
        h = torch.where(valid, h, torch.zeros_like(h))
        l = torch.where(valid, l, torch.zeros_like(l))
    else:
        h = torch.where(valid, torch.log(safe), torch.zeros_like(safe))
        l = None
    bad = torch.sum(torch.where(valid, torch.zeros_like(flat), torch.log(flat)), dim=-1)
    return h, l, bad


def accurate_sum_of_logs(x: torch.Tensor, where=None, dim=None) -> torch.Tensor:
    """sum(log x) over all elements of ``x``, or along ``dim`` for each
    slice: accurate per-element logs in f32 plus a double-word reduction;
    entries where ``where`` (x's shape) is False contribute exactly 0."""
    if dim is None:
        flat = x.reshape(-1)
        where = None if where is None else torch.as_tensor(where).reshape(-1)
    else:
        flat = torch.movedim(x, dim, -1)
        where = None if where is None else torch.movedim(torch.as_tensor(where), dim, -1)
    if where is not None:
        flat = torch.where(where, flat, torch.ones_like(flat))
    h, l, bad = _guarded_log_terms(flat)
    sh, sl = dw_sum(h, l)
    return sh + sl + bad


def dw_log_determinant(L: torch.Tensor):
    """2 sum(log diag(L)) as (hi, lo): accurate per-element logs and a
    double-word reduction; an invalid diagonal entry propagates -inf / NaN
    exactly."""
    lh, ll, bad = _guarded_log_terms(torch.diagonal(L))
    h, l = dw_sum(lh, ll)
    return 2.0 * (h + bad), 2.0 * l


def refined_quadratic(chol, K: torch.Tensor, y: torch.Tensor, refine_steps: int = 2):
    """y^T K^-1 y as a double word (hi, lo), by iterative refinement with a
    double-word residual.

    alpha = fl(K^-1 y) carries a forward error ~ kappa(K) eps, and a
    residual formed in working precision is noise at that level, so
    r = y - K alpha runs through ``dw_matvec``.  Each step contracts the
    error by ~kappa eps; the first dot product is compensated (``dot2``),
    the corrections, O(kappa eps) of the result, are plain."""
    alpha = chol.solve(y)
    qh, ql = dot2(y, alpha)
    corr = torch.zeros_like(qh)
    for _ in range(refine_steps):
        kh, kl = dw_matvec(K, alpha)
        rh, re = two_sum(y, -kh)
        delta = chol.solve(rh + (re - kl))
        alpha = alpha + delta
        corr = corr + torch.dot(y, delta)
    return two_sum(qh, ql + corr)


def blocked_cholesky_dw(K: torch.Tensor, block_size: int | None = None, rhs: torch.Tensor | None = None,
                        assemble: bool = True):
    """Blocked Cholesky with a double-word trailing matrix.

    Each trailing update T -= L_k L_k^T rounds every trailing entry once
    per panel in the plain loop.  Here each column panel's active rows are
    carried as an unevaluated (hi, lo) pair: the subtraction runs through
    ``two_sum``, the remainder accumulates in ``lo``, and each panel folds
    its carry in before it is factored, so every panel's input is one
    rounding from exact.  Each diagonal panel's factor and inverse come
    from ``_panel_chol_inverse``: the panel kernel for CUDA f32, the plain
    version (library Cholesky plus ``blocked_tri_inverse``) elsewhere.

    Returns L, (L, z) with ``rhs`` (z = L^-1 rhs), or with
    ``assemble=False`` (needs ``rhs``) (diag(L), z) without the n x n
    factor.  The block size is ``default_block_size`` (on CUDA f32 at most
    1024); n that it does not divide is padded with an identity block.
    Every list update is out of place, so autograd differentiates it."""
    from .blocked_cholesky import _panel_chol_inverse, cholesky, default_block_size

    n_orig = n = K.shape[0]
    if not assemble and rhs is None:
        raise ValueError("assemble=False requires rhs (the NLML fused path)")
    b = block_size if block_size is not None else default_block_size(n, K.device, K.dtype)
    if n <= b:
        L = cholesky(K)
        z0 = None if rhs is None else torch.linalg.solve_triangular(L, rhs[:, None], upper=False)[:, 0]
        if not assemble:
            return torch.diagonal(L), z0
        return L if rhs is None else (L, z0)
    if n % b != 0:  # chol of blkdiag(K, I) is blkdiag(L, I)
        m = -(-n // b) * b
        K = torch.nn.functional.pad(K, (0, m - n, 0, m - n))
        K = K + torch.diag(torch.cat([K.new_zeros(n), K.new_ones(m - n)]))
        if rhs is not None:
            rhs = torch.nn.functional.pad(rhs, (0, m - n))
        n = m
    G = n // b
    cols_hi = [K[k * b:, k * b:(k + 1) * b] for k in range(G)]
    cols_lo = [None] * G
    tail = rhs  # rows k0.. of the partly whitened right-hand side
    out_cols, diags, white = [], [], []
    for k in range(G):
        k0 = k * b
        ph = cols_hi[k] if cols_lo[k] is None else cols_hi[k] + cols_lo[k]  # fold the carry
        cols_hi[k] = cols_lo[k] = None
        Lkk, W = _panel_chol_inverse(ph[:b].contiguous())
        below = ph[b:] @ W.T  # (n - k0 - b, b)
        if assemble:
            out_cols.append(torch.cat([ph.new_zeros((k0, b)), Lkk, below]))
        else:
            diags.append(torch.diagonal(Lkk))
        if tail is not None:
            zk = W @ tail[:b]
            white.append(zk)
            tail = tail[b:] - below @ zk
        for j in range(k + 1, G):
            r0 = (j - k - 1) * b
            s, e = two_sum(cols_hi[j], -(below[r0:] @ below[r0:r0 + b].T))
            cols_hi[j] = s
            cols_lo[j] = e if cols_lo[j] is None else cols_lo[j] + e
    z = None if rhs is None else torch.cat(white)[:n_orig]
    if not assemble:
        return torch.cat(diags)[:n_orig], z
    L = torch.cat(out_cols, dim=1)[:n_orig, :n_orig]
    return L if rhs is None else (L, z)


LOG_2PI = math.log(2.0 * math.pi)


def compensated_nll_dw(chol, K: torch.Tensor, y: torch.Tensor):
    """1/2 (log|K| + y^T K^-1 y + n log 2 pi) as an unevaluated double word
    (hi, lo).  ``K`` must be the matrix that was factorized into ``chol``
    (jitter and target variance included).  The three O(n) terms partly
    cancel, so they are combined in double word; hi + lo in f64 on the
    host shows the accuracy below one f32 ulp of the result."""
    n = y.shape[0]
    ldh, ldl = dw_log_determinant(chol.L)
    qh, ql = refined_quadratic(chol, K, y)
    prod = float(n) * LOG_2PI  # exact enough in Python's f64 for any n
    nh = float(torch.tensor(prod, dtype=y.dtype))
    nl = prod - nh
    sh, sl = dw_add(ldh, ldl, qh, ql)
    sh, sl = dw_add(sh, sl, torch.tensor(nh, dtype=y.dtype, device=y.device),
                    torch.tensor(nl, dtype=y.dtype, device=y.device))
    return 0.5 * sh, 0.5 * sl


def compensated_nll(chol, K: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Single-word 1/2 (log|K| + y^T K^-1 y + n log 2 pi); see
    ``compensated_nll_dw``."""
    h, l = compensated_nll_dw(chol, K, y)
    return h + l
