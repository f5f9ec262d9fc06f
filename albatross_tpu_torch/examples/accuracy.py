"""NLML accuracy-mode walkthrough through the port.

    python -m albatross_tpu_torch.examples.accuracy [--n 3000] [--device cpu]

Builds a moderately ill-conditioned f32 GP covariance, computes its NLML
in each accuracy mode (``config.NLML_COMPENSATED``,
``config.CHOLESKY_PRECISION``) and prints each mode's relative error
against an f64 oracle computed from the same f32 covariance on the same
device:

  plain f32:   the blocked loop in f32;
  compensated: double-word reductions and iterative refinement of the
               quadratic term;
  chol=highest / double_word: the factorization's modes ("highest" is the
               default full-f32 path here; "double_word" carries the
               trailing matrix as a (hi, lo) pair).

The counterpart of the JAX package's ``examples/accuracy.py``, whose
double-word row runs eagerly on the JAX CPU backend; the port has no
tracing, so every row runs as it is.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from .. import config
from ..core import RegressionDataset
from ..kernels import IndependentNoise, SquaredExponential, as_measurement, measurement_only
from ..models import gp_from_covariance

# (name, CHOLESKY_PRECISION, NLML_COMPENSATED)
MODES = (
    ("plain f32", None, False),
    ("compensated", None, True),
    ("compensated + chol=highest", "highest", True),
    ("compensated + chol=double_word", "double_word", True),
)


def run(n: int = 3000, device=None, dtype=torch.float32) -> dict:
    """``oracle`` (the f64 log-likelihood of the f32 covariance) and
    ``modes``: name -> (log-likelihood, relative error against it)."""
    dev = config.device(device)
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 100.0, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    data = RegressionDataset.create(x.astype(np.float32), y.astype(np.float32), device=dev, dtype=dtype)
    kernel = SquaredExponential(5.0, 1.0) + measurement_only(IndependentNoise(0.1, assume_unique=True))
    model = gp_from_covariance(kernel)

    # the f64 oracle on the same covariance the modes factor
    K64 = kernel(as_measurement(data.features)).double()
    y64 = data.targets.mean.double()
    L64 = torch.linalg.cholesky(K64)
    del K64
    w64 = torch.linalg.solve_triangular(L64, y64[:, None], upper=False)[:, 0]
    oracle = float(-0.5 * (2.0 * torch.sum(torch.log(torch.diagonal(L64))) + w64 @ w64 + n * math.log(2.0 * math.pi)))
    del L64

    modes = {}
    before = config.CHOLESKY_PRECISION, config.NLML_COMPENSATED
    for name, precision, compensated in MODES:
        try:
            config.CHOLESKY_PRECISION, config.NLML_COMPENSATED = precision, compensated
            ll = float(model.log_likelihood(data))
        finally:
            config.CHOLESKY_PRECISION, config.NLML_COMPENSATED = before
        modes[name] = (ll, abs(ll - oracle) / abs(oracle))
    return {"oracle": oracle, "modes": modes}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=3000)
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.n, args.device)
    print(f"f64 oracle log-likelihood: {out['oracle']:.6f}")
    for name, (ll, rel) in out["modes"].items():
        print(f"{name:32s} ll={ll:+.6f}  rel error vs f64 = {rel:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
