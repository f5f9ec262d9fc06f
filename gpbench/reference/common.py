"""What the float64 references of every model share: the squared
exponential gram, the training covariance, the priors, and the value and
gradient by autograd.

Closed-form grams, ``torch.linalg.cholesky``, triangular solves and
autograd; nothing else.  An objective is ``objective(data, params,
config)`` and a posterior ``Posterior(config, data)``, ``data`` the
training set (``x``, ``y``, each target's ``variance`` or None) in
float64.  As upstream's ``gp.hpp`` does, a fit (the posterior) adds the
targets' variance to the training covariance, and the log likelihood
does not.  No module of ``reference/`` imports the program
under test or JAX: each works every factor, inverse and inducing set out
again from the inputs that the benchmark made, and reads the program's
outputs only to judge them.

``params`` maps a role (``length_scale``, ``sigma``, ``noise``,
``measurement_nugget``, ``inducing_nugget``) to a 0-d float64 tensor, so
autograd gives the gradient with respect to each.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def radial_gram(a, b, length_scale, sigma, radial: str):
    """(len(a), len(b)) gram of 1-D inputs: sigma^2 exp(-|a_i - b_j|^2 / length_scale^2)."""
    if radial != "SquaredExponential":
        raise ValueError(f"no reference for the radial kernel {radial!r}")
    d2 = torch.sub(a[:, None], b[None, :]).square_()  # in place: the inputs need no gradient
    return sigma * sigma * torch.exp(d2 * (-1.0 / (length_scale * length_scale)))


def prior_log_pdf(priors: dict) -> float:
    """Sum of the configuration's prior log-densities at values inside
    their bounds: a uniform prior's is -log(upper - lower); positive and
    non-negative priors, which the configuration leaves out, add 0."""
    total = 0.0
    for prior in priors.values():
        (lower, upper), = prior.values()
        total -= math.log(upper - lower)
    return total


def training_covariance(x, params, kernel: dict, jitter: float, variance=None):
    """K(x, x) + (noise^2 + jitter) I, noise on the diagonal only, plus
    diag(``variance``) where given.  The diagonal is added in place: at
    N = 28672 each N x N float64 temporary is 6.6 GB."""
    K = radial_gram(x, x, params["length_scale"], params["sigma"], kernel["radial"])
    K.diagonal().add_(params["noise"] * params["noise"] + jitter)
    if variance is not None:
        K.diagonal().add_(variance)
    return K


def value_grad(objective, config: dict, data, named: dict):
    """(value, {tunable name: gradient}) of ``objective(data, params,
    config)`` minus the prior log-density at the tunable values ``named``
    (name -> float, log-scale entries as logs), by autograd in float64."""
    leaves = {name: torch.tensor(v, dtype=torch.float64, device=data.x.device, requires_grad=True)
              for name, v in named.items()}
    params = {}
    for name, spec in config["tunable"].items():
        leaf = leaves[name]
        params[spec["role"]] = torch.exp(leaf) if spec.get("log_scale") else leaf
    value = objective(data, params, config) - prior_log_pdf(config["priors"])
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.item(), {name: g.item() for name, g in zip(leaves, grads)}
