"""Ensemble-MCMC example through the port.

    python -m albatross_tpu_torch.examples.sampler [--n 40] [--walkers 16] [--iterations 200] [--burn-in 100]
        [--output sampler_chains.csv] [--device cpu]

Tunes an exact GP by L-BFGS on its likelihood, then samples its
hyperparameter posterior with the affine-invariant ensemble sampler,
writing every iteration's walkers to CSV.  The counterpart of the JAX
package's ``examples/sampler.py``, on the same numpy data; the chain's
key (42) seeds a ``torch.Generator``, so the chain matches the JAX one in
distribution, not draw for draw.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config
from ..core import FixedPrior, LogScaleUniformPrior, RegressionDataset
from ..evaluation import GaussianProcessNegativeLogLikelihood
from ..kernels import IndependentNoise, SquaredExponential, measurement_only
from ..models import gp_from_covariance
from ..samplers import CsvWritingCallback, MaximumLikelihoodTrackingCallback, ensemble_sampler_from_model
from ..tuning import get_tuner

TRUTH_LENGTH_SCALE, TRUTH_SIGMA, NOISE_SD = 3.0, 2.0, 0.3


def make_data(n: int, device=None, dtype=torch.float64) -> RegressionDataset:
    """n sorted points on [0, 20] with targets drawn from the true GP."""
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0.0, 20.0, n))
    K = TRUTH_SIGMA**2 * np.exp(-(((x[:, None] - x[None, :]) / TRUTH_LENGTH_SCALE) ** 2)) + NOISE_SD**2 * np.eye(n)
    y = np.linalg.cholesky(K + 1e-12 * np.eye(n)) @ rng.standard_normal(n)
    return RegressionDataset.create(x, y, device=config.device(device), dtype=dtype)


def tune(data: RegressionDataset):
    """(the model tuned by L-BFGS on its NLML over ``data``, the tuning
    result): the sampler's starting point."""
    kernel = (
        (SquaredExponential(1.0, 1.0) + measurement_only(IndependentNoise(NOISE_SD)))
        .set_param_prior("squared_exponential_length_scale", LogScaleUniformPrior(1e-2, 1e3))
        .set_param_prior("sigma_squared_exponential", LogScaleUniformPrior(1e-2, 1e3))
        .set_param_prior("sigma_independent_noise", FixedPrior())
    )
    return get_tuner(gp_from_covariance(kernel), GaussianProcessNegativeLogLikelihood(), data, optimizer="lbfgs",
                     max_iterations=60).tuned_model()


def _interval(samples: np.ndarray) -> tuple:
    """(median, 5%, 95%) of the positive-scale samples."""
    return float(np.median(samples)), float(np.quantile(samples, 0.05)), float(np.quantile(samples, 0.95))


def run(n: int = 40, walkers: int = 16, iterations: int = 200, burn_in: int = 100,
        output: str = "sampler_chains.csv", device=None, dtype=torch.float64) -> dict:
    """``tuned_nlml``; the chain's ``acceptance_rate``, ``log_prob``
    (iterations + 1, walkers) and the tracker's ``best_log_prob`` and
    ``best_iteration``; the posterior ``length_scale`` and ``sigma`` as
    (median, 5%, 95%); the CSV's parameter ``names``."""
    data = make_data(n, device, dtype)
    # tune to a good starting point first, as the reference's example does
    model, result = tune(data)
    tracker = MaximumLikelihoodTrackingCallback()
    params = model.get_params()
    names = [name for name in sorted(params) if not params[name].is_fixed]
    with open(output, "w", newline="") as stream:
        csv_cb = CsvWritingCallback(stream, names)

        def callback(i, state):
            tracker(i, state)
            csv_cb(i, state)

        chain = ensemble_sampler_from_model(model, data, n_walkers=walkers, max_iterations=iterations, key=42,
                                            callback=callback)
    samples = chain.flat_samples(burn_in=burn_in)
    return {
        "tuned_nlml": float(result.value),
        "acceptance_rate": chain.acceptance_rate(),
        "log_prob": chain.log_prob,
        "length_scale": _interval(np.exp(samples[:, names.index("squared_exponential_length_scale")])),
        "sigma": _interval(np.exp(samples[:, names.index("sigma_squared_exponential")])),
        "best_log_prob": tracker.best_log_prob,
        "best_iteration": tracker.best_iteration,
        "names": names,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=40)
    parser.add_argument("--walkers", type=int, default=16)
    parser.add_argument("--iterations", type=int, default=200)
    parser.add_argument("--burn-in", type=int, default=100)
    parser.add_argument("--output", default="sampler_chains.csv")
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.n, args.walkers, args.iterations, args.burn_in, args.output, args.device)
    print(f"tuned NLML: {out['tuned_nlml']:.4f}")
    print(f"acceptance rate: {out['acceptance_rate']:.2f}")
    for what, (median, lo, hi), truth in (("length_scale", out["length_scale"], TRUTH_LENGTH_SCALE),
                                          ("sigma", out["sigma"], TRUTH_SIGMA)):
        print(f"posterior {what}: median {median:.3f} 90% CI [{lo:.3f}, {hi:.3f}]  (truth {truth})")
    print(f"max log-prob {out['best_log_prob']:.4f} at iteration {out['best_iteration']}; "
          f"chains -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
