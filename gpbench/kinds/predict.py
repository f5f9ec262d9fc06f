"""One client's closed loop of marginal predictions: the model is fitted
once in set-up, then each step predicts the mean and variance at the next
batch of fresh seeded inputs and reads them back to the host.

The mix (``traffic/<mix>.json``) gives ``batch``, the inputs a step, and
the parameters that the configuration's data law (``data/<law>.py``)
draws them by: the sine law's ``low`` and ``high``.

The check compares, the worst over a seeded sample of the window's
batches, the largest error of a batch's means (``mean``) and of its
variances (``variance``) over the largest reference entry of that batch;
the reference is ``reference/<model>.py``'s ``Posterior``.
"""

from __future__ import annotations

import torch

from gpbench import generator
from gpbench.check import worst


class Loop:
    def __init__(self, cell, program, seed: int):
        self.config, self.traffic, self.seed, self.law = cell.config, cell.traffic, seed, cell.law
        self.device = program.x.device
        self.fit = program.model.fit(program.data)

    def inputs(self, i: int, stream: int = generator.BATCHES) -> torch.Tensor:
        return self.law.predict_points(self.config, self.traffic, self.seed, i, self.device, stream)

    def step(self, xs: torch.Tensor) -> torch.Tensor:
        """The (2, batch) means and variances, on the host."""
        marginal = self.fit.predict(xs).marginal()
        return torch.stack([marginal.mean, marginal.variance]).cpu()

    @staticmethod
    def finite(answer) -> bool:
        return bool(torch.isfinite(answer).all())


def readings(cell, data, answers: list, sample: list, seed: int, detail: list | None = None) -> dict:
    """``answers`` holds the (2, batch) host tensor of each batch i, whose
    inputs the law's ``predict_points(..., i)`` makes again."""
    with torch.no_grad():
        posterior = cell.reference.Posterior(cell.config, data.to(torch.float64))
        means, variances = [], []
        for i in sample:
            xs = cell.law.predict_points(cell.config, cell.traffic, seed, i, data.x.device).double()
            ref_mean, ref_var = (t.cpu() for t in posterior.marginal(xs))
            got = answers[i].double()
            means.append(float((got[0] - ref_mean).abs().max() / ref_mean.abs().max()))
            variances.append(float((got[1] - ref_var).abs().max() / ref_var.abs().max()))
            if detail is not None:
                detail.append({"step": i, "mean": means[-1], "variance": variances[-1]})
    return {"mean": worst(means), "variance": worst(variances)}
