"""Model-inspection example through the port.

    python -m albatross_tpu_torch.examples.inspection [--device cpu]

Introspects a composed covariance (its call trace with each node's
value), dumps the parameters and priors, records run metadata in the
model's insights, and diagnoses an ill-conditioned covariance by its
smallest eigen directions.  The counterpart of the JAX package's
``examples/inspection.py``: the same text, line for line.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import config
from ..core import pretty_priors
from ..kernels import Constant, Exponential, IndependentNoise, SquaredExponential, as_measurement, measurement_only
from ..models import gp_from_covariance
from ..ops.diagnostics import print_small_eigen_directions


def run(device=None, dtype=torch.float64) -> dict:
    """The example's text, section by section: ``kernel_name``,
    ``trace`` (x = 1.0, y = 2.5), ``training_trace`` (a Measurement pair),
    ``param_details``, ``priors``, ``insights`` and ``eigen`` (the
    smallest eigen direction of a nearly singular gram), with
    ``smallest_eigenvalue`` and ``trace_value`` as numbers."""
    dev = config.device(device)
    kernel = (Constant(3.0) + SquaredExponential(2.0, 1.5) * Exponential(5.0, 1.0)
              + measurement_only(IndependentNoise(0.2)))
    model = gp_from_covariance(kernel)

    def scalar(v):
        return torch.tensor(v, device=dev, dtype=dtype)

    trace = kernel.call_trace(scalar(1.0), scalar(2.5))
    training_trace = kernel.call_trace(as_measurement(scalar(1.0)), as_measurement(scalar(1.0)))
    model.insights["example"] = "inspection"
    model.insights["kernel"] = kernel.name
    # nearly duplicated inputs with no noise: a nearly singular gram
    x = torch.tensor([1.0, 1.0 + 1e-9, 5.0, 9.0], device=dev, dtype=dtype)
    K = SquaredExponential(2.0, 1.0)(x)
    eigenvalues = torch.linalg.eigvalsh(K)
    return {
        "kernel_name": kernel.name,
        "trace": trace.pretty(),
        "trace_value": float(trace.value),
        "training_trace": training_trace.pretty(),
        "param_details": model.pretty_param_details(),
        "priors": pretty_priors(model.get_params()),
        "insights": dict(model.insights),
        "eigen": print_small_eigen_directions(K, k=1, top_entries=4),
        "smallest_eigenvalue": float(eigenvalues[0]),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    out = run(args.device)
    print("=== kernel expression ===")
    print(out["kernel_name"])
    print("\n=== call trace at (x=1.0, y=2.5) ===")
    print(out["trace"])
    print("\n=== call trace for a TRAINING pair (Measurement-tagged) ===")
    print(out["training_trace"])
    print("\n=== parameters ===")
    print(out["param_details"])
    print("=== priors ===")
    print(out["priors"])
    print("insights:", out["insights"])
    print("\n=== diagnosing an ill-conditioned covariance ===")
    print(out["eigen"])
    print("the smallest eigenvector loads on indices 0/1 — the nearly-duplicate features.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
