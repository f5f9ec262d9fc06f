"""The upstream temperature model in float64, in plain torch (swift-nav/
albatross ``examples/temperature_example/temperature_example.cc``):

    elevation_scaled(Constant) + measurement_only(IndependentNoise)
      + Exponential[angular] * SquaredExponential[radial]

over station rows (ECEF x, y, z, elevation).  Its objective ``nlml``,
which adds no target variance (upstream's ``log_likelihood``), and its
``Posterior``, whose fit adds it (upstream's ``gp.hpp``).  The arithmetic
is ``tests/reference_temperature.py``'s, the repository's reference, to
the operation: the tests hold the two equal to the bit.

Departures from upstream, each for a reason: the metrics read the ECEF
block of a row, as the port's ``StationDistance`` hands it; row norms are
``torch.linalg.vector_norm`` (Eigen's ``norm()`` may differ in the last
bit, which near an angle of 0 moves it by about 1.5e-8 rad); the noise
compares whole rows and counts only between two measured batches, as
upstream's ``measurement_only(IndependentNoise)`` does.
"""

from __future__ import annotations

import math

import torch

from gpbench.reference.common import LOG_2PI

EPSILON = 1e-16  # upstream's guard of acos near +-1


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
    """1 + factor max(0, center - elevation)."""
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


def parameters(config: dict, params: dict | None = None) -> dict:
    """Every parameter by its name in the port: the tunable ones from
    ``params`` (the roles of ``config["tunable"]``), the rest at the
    configuration's values."""
    return {**config["kernel"], **(params or {})}


def nlml(data, params, config: dict):
    """1/2 (log|K| + y^T K^-1 y + n log 2 pi), K with no target variance."""
    K = covariance(data.x, data.x, parameters(config, params), measured=True)
    K.diagonal().add_(config["jitter"])
    L = torch.linalg.cholesky(K)
    del K
    white = torch.linalg.solve_triangular(L, data.y[:, None], upper=False)[:, 0]
    return 0.5 * (2.0 * torch.log(torch.diagonal(L)).sum() + white @ white + data.x.shape[0] * LOG_2PI)


class Posterior:
    """The model fitted at the configuration's parameters, each target's
    variance added to the training covariance: marginal predictions (mean
    and variance of the latent field) at any rows."""

    def __init__(self, config: dict, data):
        self.x, self.p = data.x, parameters(config)
        K = covariance(data.x, data.x, self.p, measured=True)
        K.diagonal().add_(data.variance + config["jitter"])
        self.L = torch.linalg.cholesky(K)
        self.alpha = torch.cholesky_solve(data.y[:, None], self.L)[:, 0]

    def marginal(self, xs):
        cross = covariance(self.x, xs, self.p, measured=False)
        v = torch.linalg.solve_triangular(self.L, cross, upper=False)
        return cross.T @ self.alpha, prior_variance(xs, self.p) - torch.sum(v * v, dim=0)
