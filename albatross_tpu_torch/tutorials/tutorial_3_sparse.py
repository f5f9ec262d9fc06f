"""Tutorial 3 through the port: sparse (inducing point) Gaussian processes.

    python -m albatross_tpu_torch.tutorials.tutorial_3_sparse [--device cpu]

FITC and PITC approximations, how the inducing-point count trades
accuracy for cost, online updates and rebasing onto other inducing
points.  The counterpart of the JAX package's
``tutorials/tutorial_3_sparse.py``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config
from ..core import RegressionDataset
from ..indexing import KFoldGrouper
from ..kernels import IndependentNoise, SquaredExponential, measurement_only
from ..models import (
    UniformlySpacedInducingPoints,
    gp_from_covariance,
    rebase_inducing_points,
    sparse_gp_from_covariance,
)

INDUCING_COUNTS = (5, 10, 20, 40)


def _grid(count: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.linspace(0, 30, count), device=like.device, dtype=like.dtype)


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def run(device=None, dtype=torch.float64) -> dict:
    """``err_by_inducing`` (FITC's largest mean error against the exact GP
    by inducing count), ``pitc_err``, ``update_err`` (a fit streamed in two
    halves against the batch fit), ``rebase_err`` and the exact
    ``exact_mean``."""
    dev = config.device(device)
    rng = np.random.default_rng(9)
    n = 400
    x = torch.as_tensor(np.sort(rng.uniform(0, 30, n)))
    y = torch.sin(x) + 0.2 * torch.as_tensor(rng.standard_normal(n))
    data = RegressionDataset.create(x, y, device=dev, dtype=dtype)
    xs = _grid(61, data.features)

    kernel = SquaredExponential(2.0, 1.0) + measurement_only(IndependentNoise(0.2))
    exact_mean = gp_from_covariance(kernel).fit(data).predict(xs).marginal().mean

    # accuracy against the number of inducing points
    err_by_inducing = {}
    for m in INDUCING_COUNTS:
        sparse = sparse_gp_from_covariance(kernel, inducing_point_strategy=UniformlySpacedInducingPoints(m))
        err_by_inducing[m] = _max_diff(sparse.fit(data).predict(xs).marginal().mean, exact_mean)

    # PITC: grouped residual blocks
    pitc = sparse_gp_from_covariance(kernel, grouper=KFoldGrouper(40),
                                     inducing_point_strategy=UniformlySpacedInducingPoints(20))
    pitc_err = _max_diff(pitc.fit(data).predict(xs).marginal().mean, exact_mean)

    # online updates: stream the data in two halves
    sparse = sparse_gp_from_covariance(kernel, inducing_point_strategy=lambda cov, feats: _grid(20, feats))
    streamed = sparse.fit(data[torch.arange(200)]).update(data[torch.arange(200, n)])
    batch = sparse.fit(data)
    update_err = _max_diff(streamed.predict(xs).mean(), batch.predict(xs).mean())
    if not update_err < 1e-6:
        raise RuntimeError(f"the streamed fit differs from the batch fit by {update_err}")

    # rebasing onto a denser grid of inducing points
    rebased = rebase_inducing_points(batch, _grid(30, data.features))
    rebase_err = _max_diff(rebased.predict(xs).mean(), batch.predict(xs).mean())
    return {"err_by_inducing": err_by_inducing, "pitc_err": pitc_err, "update_err": update_err,
            "rebase_err": rebase_err, "exact_mean": exact_mean.cpu().numpy()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.device)
    print("inducing points -> max |sparse - exact| posterior mean")
    for m, err in out["err_by_inducing"].items():
        print(f"  m={m:3d}: {err:.5f}")
    print(f"PITC (40 blocks, 20 inducing): max err {out['pitc_err']:.5f}")
    print(f"online update vs batch fit: max |diff| = {out['update_err']:.2e}")
    print(f"rebase onto denser grid: max |diff| = {out['rebase_err']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
