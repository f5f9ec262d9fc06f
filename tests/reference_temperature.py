"""The upstream temperature model in float64, in plain torch: the
repository's reference for swift-nav/albatross
``examples/temperature_example/temperature_example.cc``.

    elevation_scaled(Constant) + measurement_only(IndependentNoise)
      + Exponential[angular] * SquaredExponential[radial]

over station rows (ECEF x, y, z, elevation).  It imports neither the port
nor JAX: every metric, the scaling and the noise are written out here
from upstream's definitions.  ``gpbench/reference/temperature_f64.py`` is
the benchmark's copy of the same arithmetic, in the harness's interface.

Departures from upstream, each for a reason:

* upstream's ``AngularDistance`` works on 3-vectors; here, as in the
  port's ``StationDistance``, the metrics read the ECEF block of a row;
* row norms are ``torch.linalg.vector_norm``, the port's, where upstream
  takes Eigen's ``norm()``: the two differ in the last bit, and near an
  angle of 0 an ulp of a norm moves the angle by about 1.5e-8 rad;
* the noise compares whole rows, as upstream's ``IndependentNoise``
  compares features, and counts only between two measured batches (the
  training rows), as ``measurement_only`` does upstream;
* the log likelihood adds no target variance (upstream's
  ``log_likelihood``); a fit, the posterior, adds it (upstream's
  ``gp.hpp``).
"""

from __future__ import annotations

import math

import torch

EPSILON = 1e-16  # upstream's guard of acos near +-1
LOG_2PI = math.log(2.0 * math.pi)

# build_model's parameters (temperature_example.cc's tuned values)
PARAMETERS = {
    "elevation_scaling_center": 1000.0,
    "elevation_scaling_factor": 3.5 / 300.0,
    "sigma_constant": 1.5,
    "sigma_independent_noise": 2.0,
    "exponential_length_scale": 9e-2,
    "sigma_exponential": 3.5,
    "squared_exponential_length_scale": 15000.0,
    "sigma_squared_exponential": 2.5,
}
# the parameters that the port leaves free (sigma_exponential is fixed: the
# product has one scale)
TUNABLE = ("exponential_length_scale", "sigma_constant", "sigma_independent_noise", "sigma_squared_exponential",
           "squared_exponential_length_scale")


def angular_distance(a, b):
    """Great-circle angle of the ECEF blocks: acos of the normalised dot
    product, 0 where it exceeds 1 - EPSILON and pi below -1 + EPSILON."""
    a, b = a[:, :3], b[:, :3]
    dots = (a @ b.T) / (torch.linalg.vector_norm(a, dim=-1)[:, None] * torch.linalg.vector_norm(b, dim=-1)[None, :])
    angles = torch.arccos(torch.clamp(dots, -1.0 + EPSILON, 1.0 - EPSILON))
    angles = torch.where(dots < -1.0 + EPSILON, torch.full_like(angles, math.pi), angles)
    return torch.where(dots > 1.0 - EPSILON, torch.zeros_like(angles), angles)


def radial_distance(a, b):
    """| ||a|| - ||b|| | of the ECEF blocks: the difference of heights."""
    return torch.abs(torch.linalg.vector_norm(a[:, :3], dim=-1)[:, None]
                     - torch.linalg.vector_norm(b[:, :3], dim=-1)[None, :])


def elevation_scale(x, p):
    """1 + factor max(0, center - elevation): the constant grows below
    the centre's elevation."""
    return 1.0 + p["elevation_scaling_factor"] * torch.clamp_min(p["elevation_scaling_center"] - x[:, 3], 0.0)


def covariance(a, b, p, measured: bool):
    """(len(a), len(b)) covariance; the noise only where both sides are
    measurements (``measured``)."""
    K = p["sigma_constant"] ** 2 * elevation_scale(a, p)[:, None] * elevation_scale(b, p)[None, :]
    angular = p["sigma_exponential"] ** 2 * torch.exp(-angular_distance(a, b) / p["exponential_length_scale"])
    radial = p["sigma_squared_exponential"] ** 2 * torch.exp(
        -torch.square(radial_distance(a, b) / p["squared_exponential_length_scale"]))
    K = K + angular * radial
    if measured:
        same = torch.all(a[:, None, :] == b[None, :, :], dim=-1)
        K = K + p["sigma_independent_noise"] ** 2 * same.to(K.dtype)
    return K


def prior_variance(x, p):
    """The diagonal of the latent covariance at x (no noise)."""
    return p["sigma_constant"] ** 2 * elevation_scale(x, p) ** 2 + p["sigma_exponential"] ** 2 * p[
        "sigma_squared_exponential"] ** 2


def nlml(x, y, p, jitter: float = 0.0):
    """1/2 (log|K| + y^T K^-1 y + n log 2 pi), K with no target variance."""
    K = covariance(x, x, p, measured=True)
    K.diagonal().add_(jitter)
    L = torch.linalg.cholesky(K)
    white = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return 0.5 * (2.0 * torch.log(torch.diagonal(L)).sum() + white @ white + x.shape[0] * LOG_2PI)


class Posterior:
    """The model fitted to (x, y) with each target's ``variance`` added to
    the training covariance: marginal predictions of the latent field."""

    def __init__(self, x, y, variance, p, jitter: float = 0.0):
        self.x, self.p = x, p
        K = covariance(x, x, p, measured=True)
        K.diagonal().add_(variance + jitter)
        self.L = torch.linalg.cholesky(K)
        self.alpha = torch.cholesky_solve(y[:, None], self.L)[:, 0]

    def marginal(self, xs):
        cross = covariance(self.x, xs, self.p, measured=False)
        v = torch.linalg.solve_triangular(self.L, cross, upper=False)
        return cross.T @ self.alpha, prior_variance(xs, self.p) - torch.sum(v * v, dim=0)
