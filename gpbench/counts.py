"""The benchmark's yardstick: the card's peaks, and the operations and
bytes that each step and kernel needs, from shapes alone.

Every share of a peak or of a roofline divides by these numbers, whatever
implementation runs the step, so no implementation can read over 100%.
The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit.
``TF32_FLOP_PER_S`` is the fastest rate the card offers on f32 inputs (its
tensor cores, dense), so a kernel that moves f32 work onto the tensor cores
still reads under 100%.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 494.7e12


def nlml_flops(n: int) -> float:
    """One exact NLML: the Cholesky's n^3/3, the whitening's n^2 and the
    gram's 8 n^2 (the count that the JAX package's bench used)."""
    return n**3 / 3.0 + n * n + 8.0 * n * n


def exact_value_grad_flops(n: int) -> float:
    """The exact NLML and its gradient: three forward NLMLs."""
    return 3.0 * nlml_flops(n)


def loo_value_grad_flops(n: int) -> float:
    """Fast LOO and its gradient: three times the factor (n^3/3) and the
    triangular inverse (n^3/3) plus n^2."""
    return 3.0 * (2.0 * n**3 / 3.0 + n * n)


def fitc_value_grad_flops(n: int, m: int) -> float:
    """FITC's NLML and its gradient: three times R of the (n + m) x m tall
    QR (Householder, 2 m^2 (n + m) - 2 m^3 / 3) and K_uu's factor (m^3/3)."""
    return 3.0 * (2.0 * m * m * (n + m) - 2.0 * m**3 / 3.0 + m**3 / 3.0)


def predict_flops(n: int, m: int) -> float:
    """m marginal predictions from n training points: the least work, one
    triangular solve of n^2 m plus the mean's product 2 n m."""
    return float(n) * n * m + 2.0 * n * m


def roofline_s(nbytes: float, flops: float) -> tuple[float, str]:
    """(least seconds on the card, what bounds it): the larger of the bytes
    over the memory rate and the operations over the TF32 rate."""
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_S, flops / TF32_FLOP_PER_S
    return max(by_bytes, by_flops), "bytes" if by_bytes >= by_flops else "operations"


def gram_bytes_flops(n: int, m: int, d: int, itemsize: int, square: bool, diag: bool) -> tuple[float, float]:
    """An (n, m) radial gram: X, Y unless it is X, and the diagonal read
    once, the output written once; 3 operations a feature and 4 for the
    profile (divide, negate, exp, scale) an entry."""
    nbytes = itemsize * (n * m + n * d + (0 if square else m * d) + (n if diag else 0))
    return float(nbytes), float(n * m * (3 * d + 4))


def panel_bytes_flops(b: int, itemsize: int = 4) -> tuple[float, float]:
    """The panel factor + inverse at block size b: b^2 read, U and U^-1
    (2 b^2) written; b^3/3 for the factor and as much for the inverse."""
    return float(itemsize * 3 * b * b), 2.0 * b**3 / 3.0
