"""Sparse-GP (FITC) example through the port.

    python -m albatross_tpu_torch.examples.sparse [--n 150] [--inducing 15] [--output f.csv] [--device cpu]

Fits a sparse GP with uniformly spaced inducing points on noisy sinc data
and compares its posterior mean with the exact GP's.  The counterpart of
the JAX package's ``examples/sparse.py``, on the same numpy draws.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from .. import config
from ..core import RegressionDataset
from ..kernels import IndependentNoise, SquaredExponential, measurement_only
from ..models import UniformlySpacedInducingPoints, gp_from_covariance, sparse_gp_from_covariance
from ..utils import write_to_csv

LOW, HIGH = 3.0, 23.0


def truth(x: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.sinc((x - 5.0) / 2.0 / math.pi)


def run(n: int = 150, inducing: int = 15, output: str = "", device=None, dtype=torch.float64) -> dict:
    """The sparse and exact predictions on 101 grid points
    (``sparse_mean``, ``sparse_variance``, ``exact_mean``), the largest
    difference of the means (``max_err``) and the sparse ``nlml``."""
    dev = config.device(device)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.sort(rng.uniform(LOW, HIGH, n)))
    y = truth(x) + 0.5 * torch.as_tensor(rng.standard_normal(n))
    data = RegressionDataset.create(x, y, device=dev, dtype=dtype)

    kernel = SquaredExponential(2.0, 5.0) + measurement_only(IndependentNoise(0.5))
    sparse = sparse_gp_from_covariance(kernel, inducing_point_strategy=UniformlySpacedInducingPoints(inducing))
    dense = gp_from_covariance(kernel)

    xs = torch.as_tensor(np.linspace(LOW, HIGH, 101), device=dev, dtype=dtype)
    sparse_pred = sparse.fit(data).predict(xs).marginal()
    dense_pred = dense.fit(data).predict(xs).marginal()
    out = {
        "sparse_mean": sparse_pred.mean.cpu().numpy(),
        "sparse_variance": sparse_pred.variance.cpu().numpy(),
        "exact_mean": dense_pred.mean.cpu().numpy(),
        "max_err": float(torch.max(torch.abs(sparse_pred.mean - dense_pred.mean))),
        "nlml": float(-sparse.log_likelihood(data)),
    }
    if output:
        write_to_csv(output, RegressionDataset.create(xs, truth(xs)), sparse_pred)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=150)
    parser.add_argument("--inducing", type=int, default=15)
    parser.add_argument("--output", default="")
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.n, args.inducing, args.output, args.device)
    print(f"n={args.n} inducing={args.inducing}: max |sparse - exact| mean = {out['max_err']:.5f}")
    print(f"sparse NLML: {out['nlml']:.4f}")
    if args.output:
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
