"""The FITC sparse GP in float64: its objective, found by the name that a
tuning mix gives (``nlml``)."""

from __future__ import annotations

import torch

from gpbench.reference.common import LOG_2PI, radial_gram


def nlml(data, params, config: dict):
    """FITC's negative log likelihood by the Woodbury identity and the
    determinant lemma: Q_ff = K_fu K_uu^-1 K_uf, Lambda = diag(K_ff - Q_ff)
    + noise^2 + measurement nugget, Sigma = K_uu + K_uf Lambda^-1 K_fu, and

        NLML = 1/2 (log|Lambda| + log|Sigma| - log|K_uu| + y^T Lambda^-1 y
                    - b^T Sigma^-1 b + n log 2 pi),  b = K_uf Lambda^-1 y.

    The inducing inputs are evenly spaced over the inputs' range, in the
    configuration's precision; K_uu carries the inducing nugget.  A
    target variance has no reference here."""
    if data.variance is not None:
        raise ValueError("the FITC reference takes no target variance")
    x, y = data.x, data.y
    kernel, dtype = config["kernel"], getattr(torch, config["dtype"])
    u = torch.linspace(float(x.min()), float(x.max()), config["inducing_points"], dtype=dtype,
                       device=x.device).double()
    ls, sigma = params["length_scale"], params["sigma"]
    K_uu = radial_gram(u, u, ls, sigma, kernel["radial"])
    K_uu.diagonal().add_(params["inducing_nugget"])
    L_uu = torch.linalg.cholesky(K_uu)
    K_uf = radial_gram(u, x, ls, sigma, kernel["radial"])
    P = torch.linalg.solve_triangular(L_uu, K_uf, upper=False)
    lam = sigma * sigma - torch.sum(P * P, dim=0) + params["noise"] ** 2 + params["measurement_nugget"]
    del P
    scaled = K_uf / torch.sqrt(lam)
    L_s = torch.linalg.cholesky(K_uu + scaled @ scaled.T)
    del scaled
    b = K_uf @ (y / lam)
    c = torch.linalg.solve_triangular(L_s, b[:, None], upper=False)[:, 0]
    log_det = (torch.log(lam).sum() + 2.0 * torch.log(torch.diagonal(L_s)).sum()
               - 2.0 * torch.log(torch.diagonal(L_uu)).sum())
    quadratic = torch.sum(y * y / lam) - c @ c
    return 0.5 * (log_det + quadratic + x.shape[0] * LOG_2PI)
