"""Error-free transformations and the accurate sum of logs.

Counterpart of the part of ``albatross_tpu.ops.compensated`` that every
log-determinant on the main path uses: ``two_sum``, ``two_prod``,
``dw_sum``, ``accurate_log`` and ``accurate_sum_of_logs``.

In eager PyTorch every operation is its own launch, so a multiply and the
add that follows it never contract into an FMA, and ``two_prod`` stays
error-free without an explicit fma.
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


def dw_sum(hi, lo=None, dim: int = -1):
    """Pairwise double-word sum along ``dim``: (hi, lo) per slice, error
    O(eps^2), from a log-depth tree of vectorized two_sums."""
    hi = torch.movedim(torch.as_tensor(hi), dim, -1)
    lo = torch.zeros_like(hi) if lo is None else torch.movedim(torch.as_tensor(lo), dim, -1)
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
    # torch.func.vmap batches it (cross-validation scores every fold in one
    # vmap): the forward is elementwise
    generate_vmap_rule = True

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


def accurate_log(x: torch.Tensor):
    """f32 natural log as a double word (hi, lo), with sub-ulp error.

    x = 2^e m with m in [sqrt(1/2), sqrt(2)) by an exact bitwise reduction,
    ln m = 2 atanh((m - 1)/(m + 1)) by its series, and e ln 2 carried in
    double word.  Positive finite normal inputs only; d log x = dx / x."""
    return _AccurateLog.apply(x)


def _guarded_log_terms(flat: torch.Tensor):
    """Split sum(log) over the last axis of ``flat`` into a double-word part
    over the valid (positive finite normal) entries and a plain sum of
    builtin logs over the others, which keeps exact -inf / NaN
    propagation."""
    f32 = flat.dtype == torch.float32
    valid = torch.isfinite(flat) & (flat >= torch.finfo(flat.dtype).tiny)
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
