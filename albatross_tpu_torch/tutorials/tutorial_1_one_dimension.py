"""Tutorial 1 through the port: Gaussian processes in one dimension.

    python -m albatross_tpu_torch.tutorials.tutorial_1_one_dimension [--device cpu]

Priors as distributions over functions, conditioning on data, the length
scale's effect, and composed kernels (trend + local structure) on a 1-D
problem.  The counterpart of the JAX package's
``tutorials/tutorial_1_one_dimension.py``; its prior draws come from a
``torch.Generator`` seeded with the JAX key's integer, unless the caller
hands in the normals.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config
from ..core import RegressionDataset
from ..kernels import IndependentNoise, Polynomial, SquaredExponential, measurement_only
from ..models import gp_from_covariance
from ..utils import sample_mvn

LENGTH_SCALES = (0.3, 1.5, 8.0)


def _rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a - b) ** 2)))


def run(device=None, dtype=torch.float64, normals=None) -> dict:
    """``draws`` (three prior draws on the 101-point grid; ``normals``, an
    (101, 3) array, replaces their standard normals), the posterior's
    ``mean``, ``stddev`` and ``rmse`` against sin(x), ``rmse_by_length_scale``
    and the composed kernel's ``trend_rmse``."""
    dev = config.device(device)
    rng = np.random.default_rng(0)

    # 1. a GP prior is a distribution over functions
    xs = torch.as_tensor(np.linspace(0.0, 10.0, 101), device=dev, dtype=dtype)
    kernel = SquaredExponential(length_scale=1.5, sigma=1.0)
    model = gp_from_covariance(kernel + measurement_only(IndependentNoise(0.1)), jitter=1e-10)
    draws = sample_mvn(1, model.prior(xs), num_samples=3, normals=normals)

    # 2. conditioning on data
    x_train = torch.as_tensor(np.sort(rng.uniform(0, 10, 12)))
    y_train = torch.sin(x_train) + 0.1 * torch.as_tensor(rng.standard_normal(12))
    data = RegressionDataset.create(x_train, y_train, device=dev, dtype=dtype)
    pred = model.fit(data).predict(xs).marginal()
    stddev = torch.sqrt(pred.variance)
    # uncertainty collapses near data and grows away from it
    near = int(torch.argmin(torch.abs(xs - float(x_train[5]))))
    if not stddev[near] < stddev[0]:
        raise RuntimeError("the posterior is not tighter near the data than at the grid's end")

    # 3. the length scale controls wiggliness
    by_length_scale = {}
    for ls in LENGTH_SCALES:
        p = model.set_param_value("squared_exponential_length_scale", ls).fit(data).predict(xs).marginal()
        by_length_scale[ls] = _rmse(p.mean, torch.sin(xs))

    # 4. composition: trends + local structure
    trend_kernel = Polynomial(1, sigma=10.0) + SquaredExponential(1.0, 0.5) + measurement_only(IndependentNoise(0.1))
    trend_data = RegressionDataset.create(x_train, 0.5 * x_train + torch.sin(2 * x_train), device=dev, dtype=dtype)
    p = gp_from_covariance(trend_kernel).fit(trend_data).predict(xs).marginal()
    return {
        "draws": draws.cpu().numpy(),
        "mean": pred.mean.cpu().numpy(),
        "stddev": stddev.cpu().numpy(),
        "rmse": _rmse(pred.mean, torch.sin(xs)),
        "rmse_by_length_scale": by_length_scale,
        "trend_rmse": _rmse(p.mean, 0.5 * xs + torch.sin(2 * xs)),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.device)
    print("three prior draws, first five values each:")
    print(np.round(out["draws"][:, :5], 3))
    print(f"\nposterior: rmse vs sin(x) = {out['rmse']:.3f}, "
          f"stddev range [{out['stddev'].min():.3f}, {out['stddev'].max():.3f}]")
    for ls, rmse in out["rmse_by_length_scale"].items():
        print(f"length_scale={ls:4.1f}: rmse={rmse:.3f}")
    print(f"\ncomposed kernel recovers trend+wiggle: rmse={out['trend_rmse']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
