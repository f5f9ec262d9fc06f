"""Tutorial 5 through the port: evaluating predictive uncertainty.

    python -m albatross_tpu_torch.tutorials.tutorial_5_evaluating_uncertainty [--device cpu]

A model's mean can look fine while its uncertainty is badly calibrated:
held-out proper scores (NLL, CRPS) and the chi-squared CDF statistic over
K-fold cross-validation expose it.  The counterpart of the JAX package's
``tutorials/tutorial_5_evaluating_uncertainty.py``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config
from ..core import RegressionDataset
from ..evaluation import ChiSquaredCdf, Crps, NegativeLogLikelihood
from ..indexing import KFoldGrouper
from ..kernels import IndependentNoise, SquaredExponential, measurement_only
from ..models import gp_from_covariance

NOISE = 0.3
NOISE_ASSUMPTIONS = (0.03, 0.3, 3.0)


def run(device=None, dtype=torch.float64) -> dict:
    """``rows``: (assumed noise sigma, summed held-out NLL, mean CRPS, mean
    chi-squared CDF) for each noise assumption, over 6 folds."""
    dev = config.device(device)
    rng = np.random.default_rng(21)
    n = 60
    x = torch.as_tensor(np.sort(rng.uniform(0, 20, n)))
    y = torch.sin(x) + NOISE * torch.as_tensor(rng.standard_normal(n))
    data = RegressionDataset.create(x, y, device=dev, dtype=dtype)

    grouper = KFoldGrouper(6)
    rows = []
    for sigma in NOISE_ASSUMPTIONS:
        cv = gp_from_covariance(SquaredExponential(2.0, 1.0)
                                + measurement_only(IndependentNoise(sigma))).cross_validate()
        nll = float(torch.sum(cv.scores(NegativeLogLikelihood(), data, grouper)))
        crps = float(torch.mean(cv.scores(Crps(), data, grouper)))
        chi2 = float(torch.mean(cv.scores(ChiSquaredCdf(), data, grouper)))
        rows.append((sigma, nll, crps, chi2))

    # the well-specified model wins on the proper scores, and its chi2 CDF
    # sits away from the 0 / 1 extremes (overconfident models pile up at 1)
    nlls = [r[1] for r in rows]
    if nlls[1] != min(nlls):
        raise RuntimeError(f"the true noise level should minimize the held-out NLL: {rows}")
    if not rows[0][3] > rows[1][3]:
        raise RuntimeError(f"the overconfident model should have the more extreme chi2 CDF: {rows}")
    return {"rows": rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.device)
    print(f"noise assumption -> held-out NLL / CRPS / chi2-CDF (true noise {NOISE})")
    for sigma, nll, crps, chi2 in out["rows"]:
        print(f"  sigma={sigma:5.2f}: NLL={nll:8.2f}  CRPS={crps:.4f}  chi2-CDF={chi2:.3f}")
    print("\nthe correctly specified model minimizes held-out NLL and keeps the chi2 statistic calibrated.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
