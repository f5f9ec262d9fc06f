"""The field3d model in float64, in plain torch: its NLML, which adds no
target variance (upstream's ``log_likelihood``), and its posterior, whose
fit adds it."""

from __future__ import annotations

import torch

from gpbench.reference.common import LOG_2PI

ROLES = ("horizontal_length_scale", "sigma_horizontal", "vertical_length_scale", "sigma_vertical",
         "sigma_constant", "noise")


def _scale(x, k):
    return 1.0 + k["factor"] * torch.clamp_min(k["center"] - x[:, 2], 0.0)


def _cross(a, b, p, k):
    """Every term but the noise, (len(a), len(b))."""
    horizontal = torch.sqrt(torch.square(a[:, None, 0] - b[None, :, 0]) + torch.square(a[:, None, 1] - b[None, :, 1]))
    vertical = a[:, None, 2] - b[None, :, 2]
    product = (p["sigma_horizontal"] ** 2 * torch.exp(-horizontal / p["horizontal_length_scale"])
               * p["sigma_vertical"] ** 2 * torch.exp(-torch.square(vertical / p["vertical_length_scale"])))
    return product + p["sigma_constant"] ** 2 * _scale(a, k)[:, None] * _scale(b, k)[None, :]


def _params(config: dict, params: dict | None = None) -> dict:
    """Every role: the tunable ones from ``params``, the rest at the
    configuration's values."""
    fixed = {r: torch.tensor(config["kernel"][r], dtype=torch.float64) for r in ROLES}
    return {**fixed, **(params or {})}


def _factor(x, p, config, variance=0.0):
    K = _cross(x, x, p, config["kernel"])
    K.diagonal().add_(p["noise"] ** 2 + config["jitter"] + variance)
    return torch.linalg.cholesky(K)


def nlml(data, params, config: dict):
    L = _factor(data.x, _params(config, params), config)
    white = torch.linalg.solve_triangular(L, data.y[:, None], upper=False)[:, 0]
    return 0.5 * (2.0 * torch.log(torch.diagonal(L)).sum() + white @ white + data.x.shape[0] * LOG_2PI)


class Posterior:
    def __init__(self, config: dict, data):
        self.p, self.kernel, self.x = _params(config), config["kernel"], data.x
        self.L = _factor(data.x, self.p, config, data.variance)
        self.alpha = torch.cholesky_solve(data.y[:, None], self.L)[:, 0]

    def marginal(self, xs):
        cross = _cross(self.x, xs, self.p, self.kernel)
        v = torch.linalg.solve_triangular(self.L, cross, upper=False)
        prior = (self.p["sigma_horizontal"] ** 2 * self.p["sigma_vertical"] ** 2
                 + self.p["sigma_constant"] ** 2 * _scale(xs, self.kernel) ** 2)
        return cross.T @ self.alpha, prior - torch.sum(v * v, dim=0)
