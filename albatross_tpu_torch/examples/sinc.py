"""Exact-GP sinc example through the port.

    python -m albatross_tpu_torch.examples.sinc [--mode radial] [--tune] [--n 30] [--output f.csv] [--device cpu]

Learns y = a sinc((x - t) / w) + b + m x from noisy samples with one of
three models:

  radial_only: squared exponential + measurement noise (non-parametric)
  radial:      linear polynomial + squared exponential + noise
  parametric:  a known mean family (linear + sinc), noise-only covariance

``--tune`` first runs L-BFGS on the leave-one-out likelihood.  The
counterpart of the JAX package's ``examples/sinc.py``, on the same numpy
draws.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from .. import config
from ..core import LogScaleUniformPrior, Parameter, RegressionDataset
from ..core.parameters import host_float
from ..evaluation import LeaveOneOutLikelihood
from ..kernels import IndependentNoise, LinearMean, MeanFunction, Polynomial, SquaredExponential, measurement_only
from ..models import GaussianProcess, gp_from_covariance, gp_from_covariance_and_mean
from ..tuning import get_tuner
from ..utils import write_to_csv

LOW, HIGH = -10.0, 23.0
MODES = ("radial_only", "radial", "parametric")


def sinc_truth(x: torch.Tensor) -> torch.Tensor:
    scaled = (x - 5.0) / 2.0
    return 10.0 * torch.sinc(scaled / math.pi) + 2.0 + 0.1 * x


def make_data(n: int, noise_sd: float, seed: int = 7, device=None, dtype=torch.float64) -> RegressionDataset:
    """n sorted points on [LOW, HIGH] with noisy sinc targets, drawn (and
    computed) in f64, then placed at ``dtype`` on ``device``."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(np.sort(rng.uniform(LOW, HIGH, n)))
    y = sinc_truth(x) + noise_sd * torch.as_tensor(rng.standard_normal(n))
    return RegressionDataset.create(x, y, device=config.device(device), dtype=dtype)


class SincMean(MeanFunction):
    """Parametric sinc mean (the reference's SincFunction)."""

    def __init__(self, scale=10.0, translation=5.0, width=2.0):
        self.scale = Parameter(scale)
        self.translation = Parameter(translation)
        self.width = Parameter(width)

    @property
    def name(self):
        return "sinc"

    def _mean(self, X):
        x = torch.as_tensor(X).reshape(-1)
        scaled = (x - self.translation.value) / self.width.value
        return self.scale.value * torch.sinc(scaled / math.pi)


def build_model(mode: str) -> GaussianProcess:
    noise = IndependentNoise(1.0).set_param_prior("sigma_independent_noise", LogScaleUniformPrior(1e-3, 1e2))
    if mode == "radial_only":
        return gp_from_covariance(SquaredExponential(3.5, 100.0) + measurement_only(noise))
    if mode == "radial":
        return gp_from_covariance(Polynomial(1, sigma=100.0) + SquaredExponential(3.5, 5.7) + measurement_only(noise))
    if mode == "parametric":
        mean = LinearMean(slope=0.0, offset=0.0) + SincMean()
        return gp_from_covariance_and_mean(measurement_only(noise), mean)
    raise ValueError(f"unknown mode {mode}")


def run(mode: str = "radial", tune: bool = False, n: int = 30, output: str = "", device=None,
        dtype=torch.float64) -> dict:
    """The example's numbers: ``tuned_objective`` (with ``tune``), the
    model's ``params`` and ``param_details`` text, the prediction on 201
    grid points (``mean``, ``variance``), its ``rmse`` against the truth
    and the ``nlml`` on the data."""
    data = make_data(n, noise_sd=1.0, device=device, dtype=dtype)
    model = build_model(mode)
    out = {}
    if tune:
        model, result = get_tuner(model, LeaveOneOutLikelihood(), data, optimizer="lbfgs",
                                  max_iterations=100).tuned_model()
        out["tuned_objective"] = float(result.value)
    out["params"] = {name: host_float(p.value) for name, p in model.get_params().items()}
    out["param_details"] = model.pretty_param_details()
    xs = torch.as_tensor(np.linspace(LOW, HIGH, 201), device=data.features.device, dtype=dtype)
    pred = model.fit(data).predict(xs).marginal()
    out["mean"] = pred.mean.detach().cpu().numpy()
    out["variance"] = pred.variance.detach().cpu().numpy()
    out["rmse"] = float(torch.sqrt(torch.mean((pred.mean - sinc_truth(xs)) ** 2)))
    out["nlml"] = float(-model.log_likelihood(data))
    if output:
        write_to_csv(output, RegressionDataset.create(xs, sinc_truth(xs)), pred)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", default="radial", choices=MODES)
    parser.add_argument("--tune", action="store_true")
    parser.add_argument("--n", type=int, default=30)
    parser.add_argument("--output", default="")
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.mode, args.tune, args.n, args.output, args.device)
    if args.tune:
        print(f"tuned objective: {out['tuned_objective']:.4f}")
    print(out["param_details"])
    print(f"mode={args.mode}  prediction-vs-truth RMSE: {out['rmse']:.4f}")
    print(f"NLML: {out['nlml']:.4f}")
    if args.output:
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
