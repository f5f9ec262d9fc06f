"""The exact GP in float64: its objectives, each found by the name that a
tuning mix gives (``nlml``, ``loo``), and its posterior."""

from __future__ import annotations

import torch

from gpbench.reference.common import LOG_2PI, radial_gram, training_covariance


def nlml(x, y, params, config: dict):
    """1/2 (log|K| + y^T K^-1 y + n log 2 pi)."""
    L = torch.linalg.cholesky(training_covariance(x, params, config["kernel"], config["jitter"]))
    white = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return 0.5 * (2.0 * torch.log(torch.diagonal(L)).sum() + white @ white + x.shape[0] * LOG_2PI)


def loo(x, y, params, config: dict):
    """Summed leave-one-out negative log likelihood from the full fit: the
    held-out mean misses y_i by [K^-1 y]_i / [K^-1]_ii with variance
    1 / [K^-1]_ii."""
    L = torch.linalg.cholesky(training_covariance(x, params, config["kernel"], config["jitter"]))
    K_inv = torch.cholesky_inverse(L)
    del L
    alpha = K_inv @ y
    d = torch.diagonal(K_inv)
    return 0.5 * torch.sum(-torch.log(d) + alpha * alpha / d + LOG_2PI)


class Posterior:
    """The exact GP fitted at the configuration's parameters: marginal
    predictions (mean and variance of the latent function) at any inputs."""

    def __init__(self, config: dict, x, y):
        k = config["kernel"]
        self.params = {name: torch.tensor(k[name], dtype=torch.float64)
                       for name in ("length_scale", "sigma", "noise")}
        self.kernel, self.x = k, x
        self.L = torch.linalg.cholesky(training_covariance(x, self.params, k, config["jitter"]))
        self.alpha = torch.cholesky_solve(y[:, None], self.L)[:, 0]

    def marginal(self, xs):
        cross = radial_gram(self.x, xs, self.params["length_scale"], self.params["sigma"], self.kernel["radial"])
        mean = cross.T @ self.alpha
        v = torch.linalg.solve_triangular(self.L, cross, upper=False)
        variance = self.params["sigma"] ** 2 - torch.sum(v * v, dim=0)
        return mean, variance
