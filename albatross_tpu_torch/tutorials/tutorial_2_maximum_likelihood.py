"""Tutorial 2 through the port: maximum likelihood estimation of
hyperparameters.

    python -m albatross_tpu_torch.tutorials.tutorial_2_maximum_likelihood [--device cpu]

The marginal likelihood as a model-selection objective, with exact
gradients through the Cholesky, tuned by L-BFGS in the log space of the
log-scale parameters.  The counterpart of the JAX package's
``tutorials/tutorial_2_maximum_likelihood.py``.  It prints the gradient
with respect to the parameter values, as ``jax.grad`` over the model
does: autograd of the values themselves, not of the tunable vector (whose
log-scale entries would scale each derivative by its value).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config
from ..core import FixedPrior, LogScaleUniformPrior, RegressionDataset
from ..core.parameters import host_float
from ..evaluation import GaussianProcessNegativeLogLikelihood
from ..kernels import IndependentNoise, SquaredExponential, measurement_only
from ..models import gp_from_covariance
from ..tuning import get_tuner

TRUTH_LENGTH_SCALE, TRUTH_SIGMA, NOISE = 2.5, 1.8, 0.2


def value_gradient(metric, data, model) -> dict:
    """d metric / d value of each tunable parameter, by name."""
    names = model.get_tunable_parameters().names
    values = {name: torch.tensor(host_float(model.get_param_value(name)), dtype=torch.float64,
                                 requires_grad=True) for name in names}
    objective = metric(data, model.set_param_values(values))
    grads = torch.autograd.grad(objective, [values[name] for name in names])
    return {name: float(g) for name, g in zip(names, grads)}


def run(device=None, dtype=torch.float64) -> dict:
    """``gradient`` (by parameter value, at the start), ``nlml_before``,
    ``nlml_after``, and the recovered ``length_scale`` and ``sigma``."""
    dev = config.device(device)
    rng = np.random.default_rng(4)
    n = 50
    x = np.sort(rng.uniform(0, 20, n))
    K = TRUTH_SIGMA**2 * np.exp(-(((x[:, None] - x[None, :]) / TRUTH_LENGTH_SCALE) ** 2))
    y = np.linalg.cholesky(K + NOISE**2 * np.eye(n)) @ rng.standard_normal(n)
    data = RegressionDataset.create(x, y, device=dev, dtype=dtype)

    # log-scale priors put the optimizer in log space; fixing the noise
    # keeps the problem identifiable
    kernel = (
        (SquaredExponential(1.0, 1.0) + measurement_only(IndependentNoise(NOISE)))
        .set_param_prior("squared_exponential_length_scale", LogScaleUniformPrior(1e-2, 1e3))
        .set_param_prior("sigma_squared_exponential", LogScaleUniformPrior(1e-2, 1e3))
        .set_param_prior("sigma_independent_noise", FixedPrior())
    )
    model = gp_from_covariance(kernel)
    metric = GaussianProcessNegativeLogLikelihood()

    gradient = value_gradient(metric, data, model)
    nlml_before = float(metric(data, model))
    tuned, result = get_tuner(model, metric, data, optimizer="lbfgs", max_iterations=100).tuned_model()
    ls = host_float(tuned.get_param_value("squared_exponential_length_scale"))
    sig = host_float(tuned.get_param_value("sigma_squared_exponential"))
    if not (abs(np.log(ls / TRUTH_LENGTH_SCALE)) < 0.7 and abs(np.log(sig / TRUTH_SIGMA)) < 0.7):
        raise RuntimeError(f"L-BFGS recovered length scale {ls} and sigma {sig}, far from the truth")
    return {"gradient": gradient, "nlml_before": nlml_before, "nlml_after": float(result.value),
            "length_scale": ls, "sigma": sig}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.device)
    print("exact dNLML/dparams at the start:")
    for name, g in sorted(out["gradient"].items()):
        print(f"  {name}: {g:+.4f}")
    print(f"\nNLML before: {out['nlml_before']:.4f}")
    print(f"NLML after : {out['nlml_after']:.4f}")
    print(f"recovered length_scale={out['length_scale']:.3f} (truth {TRUTH_LENGTH_SCALE})")
    print(f"recovered sigma       ={out['sigma']:.3f} (truth {TRUTH_SIGMA})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
