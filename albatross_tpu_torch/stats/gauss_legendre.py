"""Gauss-Legendre quadrature nodes and weights.

The port's own copy of ``albatross_tpu.stats.gauss_legendre`` (numpy's
Golub-Welsch ``leggauss``; host-side set-up data).
"""

from __future__ import annotations

import numpy as np


def gauss_legendre_points(n: int, lo: float = -1.0, hi: float = 1.0):
    nodes, weights = np.polynomial.legendre.leggauss(int(n))
    scale = 0.5 * (hi - lo)
    return scale * (nodes + 1.0) + lo, weights * scale
