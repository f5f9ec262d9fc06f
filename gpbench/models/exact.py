"""The exact GP: how the port builds it, the benchmark's operation counts
of its steps, and the gram entries its steps launch."""

from __future__ import annotations

import albatross_tpu_torch as pt
from gpbench import counts

# one value+grad of each objective a tuning mix may name, fixed by the benchmark
VALUE_GRAD_FLOPS = {"nlml": counts.exact_value_grad_flops, "loo": counts.loo_value_grad_flops}


def build(config: dict, kernel):
    return pt.gp_from_covariance(kernel, jitter=config["jitter"])


def value_grad_flops(config: dict, objective: str) -> float:
    return VALUE_GRAD_FLOPS[objective](config["n"])


def predict_flops(config: dict, batch: int) -> float:
    return counts.predict_flops(config["n"], batch)


def training_gram(program):
    """(entry, bytes, operations): the (N, N) training covariance with its
    diagonal, in one launch."""
    n = program.config["n"]
    return (program.training_gram(),
            *counts.gram_bytes_flops(n, n, 1, program.x.element_size(), square=True, diag=True))


def predict_gram(program, xs):
    """(entry, bytes, operations): the (N, batch) cross covariance."""
    return (program.cross_gram(xs),
            *counts.gram_bytes_flops(program.config["n"], xs.shape[0], 1, program.x.element_size(),
                                     square=False, diag=False))
