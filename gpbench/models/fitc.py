"""The FITC sparse GP over evenly spaced inducing points: how the port
builds it, the benchmark's operation counts of its steps, and the gram
and QR entries its steps launch."""

from __future__ import annotations

import albatross_tpu_torch as pt
from gpbench import counts

# one value+grad of each objective a tuning mix may name, fixed by the benchmark
VALUE_GRAD_FLOPS = {"nlml": counts.fitc_value_grad_flops}


def build(config: dict, kernel):
    return pt.sparse_gp_from_covariance(
        kernel, inducing_point_strategy=pt.UniformlySpacedInducingPoints(config["inducing_points"]),
        measurement_nugget=config["measurement_nugget"], inducing_nugget=config["inducing_nugget"])


def value_grad_flops(config: dict, objective: str) -> float:
    return VALUE_GRAD_FLOPS[objective](config["n"], config["inducing_points"])


def training_gram(program):
    """(entry, bytes, operations): K_fu, the (N, M) cross covariance."""
    n, m = program.config["n"], program.config["inducing_points"]
    return (program.cross_gram(program.inducing_points()),
            *counts.gram_bytes_flops(n, m, 1, program.x.element_size(), square=False, diag=False))


def tall_qr(program, seed: int):
    """The tall QR of value+grad, at its (N + M, M) shape."""
    n, m = program.config["n"], program.config["inducing_points"]
    return program.tall_qr(n + m, m, seed)
