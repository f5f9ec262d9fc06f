"""A tuner's closed loop: value+grad of the mix's objective at the next
tunable vector of a seeded sequence, through ``set_tunable_params`` and
autograd, each step ending with the value and the whole gradient on the
host.

The mix (``traffic/<mix>.json``) gives ``objective``, the name of
``objectives/<objective>.py`` (the port's side) and of the function of
``reference/<model>.py`` that works it out again, and ``spread``: each
tunable entry lies within that share of the configuration's value.

The check compares, the worst over a seeded sample of the window's steps:

* ``value``: the objective's error over the reference's magnitude;
* ``gradient``: the worst leaf, each entry's error over its own
  reference magnitude, or over the objective's rounding in the
  configuration's dtype (its unit roundoff times the reference value's
  magnitude: 2^-24 for float32, 2^-53 for float64) where the entry is
  smaller than that: an entry that moves the objective by less than its
  rounding is nought to rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpbench import generator
from gpbench.check import worst
from gpbench.reference.common import value_grad



class Loop:
    def __init__(self, cell, program, seed: int):
        self.program, self.traffic, self.seed = program, cell.traffic, seed
        tunable = program.model.get_tunable_parameters()
        self.names = list(tunable.names)
        if self.names != sorted(cell.config["tunable"]):
            raise ValueError(f"the model's tunable parameters {self.names} are not the configuration's "
                             f"{sorted(cell.config['tunable'])}")
        self.x0 = tunable.values.numpy().copy()
        self.objective = cell.objective().value

    def inputs(self, i: int, stream: int = generator.TUNABLE) -> np.ndarray:
        return generator.tunable_vector(self.x0, self.traffic, self.seed, i, stream)

    def step(self, vector: np.ndarray):
        """(tunable vector, value, gradient) on the host."""
        x = torch.tensor(vector, dtype=torch.float64, requires_grad=True)
        value = self.objective(self.program.model.set_tunable_params(x), self.program.data)
        (grad,) = torch.autograd.grad(value, x)
        return vector, value.item(), grad.numpy()

    @staticmethod
    def finite(answer) -> bool:
        _, value, grad = answer
        return math.isfinite(value) and bool(np.all(np.isfinite(grad)))


def unit_roundoff(dtype: str) -> float:
    """Half the gap between 1 and the next number of ``dtype``: 2^-24 for
    float32, 2^-53 for float64."""
    return torch.finfo(getattr(torch, dtype)).eps / 2


def leaf_gaps(grad, ref_grad, ref_value: float, dtype: str) -> np.ndarray:
    """Each gradient entry's error over its own reference magnitude, or
    over the objective's rounding in ``dtype`` where the entry is below it."""
    ref_grad = np.asarray(ref_grad, dtype=np.float64)
    scale = np.maximum(np.abs(ref_grad), unit_roundoff(dtype) * abs(ref_value))
    return np.abs(np.asarray(grad, dtype=np.float64) - ref_grad) / scale


def readings(cell, data, answers: list, sample: list, seed: int, detail: list | None = None) -> dict:
    """``answers`` holds (tunable vector, value, gradient) of each step;
    ``detail``, where given, gets each sampled step's raw numbers."""
    names = sorted(cell.config["tunable"])
    objective = getattr(cell.reference, cell.traffic["objective"])
    data64 = data.to(torch.float64)
    values, grads = [], []
    for i in sample:
        vector, value, grad = answers[i]
        ref_value, ref_grad = value_grad(objective, cell.config, data64, dict(zip(names, vector.tolist())))
        ref_grad = [ref_grad[n] for n in names]
        gaps = leaf_gaps(grad, ref_grad, ref_value, cell.config["dtype"])
        values.append(abs(value - ref_value) / abs(ref_value))
        grads.append(float(np.max(gaps)))
        if detail is not None:
            detail.append({"step": i, "names": names, "value": value, "ref_value": ref_value,
                           "grad": np.asarray(grad).tolist(), "ref_grad": ref_grad, "leaf_gaps": gaps.tolist()})
    return {"value": worst(values), "gradient": worst(grads)}
