"""Tutorial 4 through the port: the state-space (Markov) view of
one-dimensional GPs.

    python -m albatross_tpu_torch.tutorials.tutorial_4_state_space [--device cpu]

A Matern 3/2 GP on ordered 1-D inputs is a Markov process, so absorbing
one observation at a time (what a Kalman filter does, here by the online
``update``) reproduces the batch posterior.  The counterpart of the JAX
package's ``tutorials/tutorial_4_state_space.py``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config
from ..core import RegressionDataset
from ..kernels import IndependentNoise, Matern32
from ..models import gp_from_covariance

TOLERANCE = 1e-8


def run(device=None, dtype=torch.float64) -> dict:
    """``mean_err`` and ``var_err`` (one-row updates against the batch
    fit), the batch ``mean`` and ``variance``, and ``improved``, the grid
    points whose full-data variance is at most the half-data variance (of
    ``points``)."""
    dev = config.device(device)
    rng = np.random.default_rng(12)
    n = 30
    x = torch.as_tensor(np.sort(rng.uniform(0, 10, n)))
    y = torch.sin(x) + 0.1 * torch.as_tensor(rng.standard_normal(n))
    data = RegressionDataset.create(x, y, variance=np.full((n,), 0.01), device=dev, dtype=dtype)

    # Matern 3/2: the Markov process of order 2 (position and derivative)
    model = gp_from_covariance(Matern32(2.0, 1.0) + IndependentNoise(0.1))
    xs = torch.as_tensor(np.linspace(0, 10, 21), device=dev, dtype=dtype)
    batch = model.fit(data).predict(xs).marginal()

    # the filter: absorb observations strictly one at a time
    fit_model = model.fit(data[[0]])
    for i in range(1, n):
        fit_model = fit_model.update(data[[i]])
    filtered = fit_model.predict(xs).marginal()
    mean_err = float(torch.max(torch.abs(filtered.mean - batch.mean)))
    var_err = float(torch.max(torch.abs(filtered.variance - batch.variance)))
    if not (mean_err < TOLERANCE and var_err < TOLERANCE):
        raise RuntimeError(f"sequential and batch posteriors differ: mean {mean_err}, variance {var_err}")

    # the smoother view: predictions at interior points use all the data
    half = model.fit(data[torch.arange(n // 2)]).predict(xs).marginal()
    improved = batch.variance <= half.variance + 1e-12
    return {"mean_err": mean_err, "var_err": var_err, "mean": batch.mean.cpu().numpy(),
            "variance": batch.variance.cpu().numpy(), "improved": int(improved.sum()),
            "points": improved.numel()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.device)
    print(f"sequential vs batch: max |mean diff| = {out['mean_err']:.2e}")
    print(f"sequential vs batch: max |var  diff| = {out['var_err']:.2e}")
    print("the recursive (Kalman-style) and batch GP posteriors agree.")
    print(f"full-data (smoother) variance <= half-data variance at "
          f"{out['improved']}/{out['points']} query points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
