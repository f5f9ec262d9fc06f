"""The system under test, albatross_tpu_torch, as one cell builds it.

This module, ``models/`` and ``objectives/`` are the only ones of the
benchmark that import the program.  ``Program`` builds the configuration's
covariance through the port's public API: the model module's own
``covariance(config)`` where it defines one, else the radial kernel that
``config["kernel"]`` names plus measurement noise.  It hands that to the
model's module (``models/<model>.py``) to make the model, and holds the
training data, with each target's variance where the data law gives one.
It also hands out the port's own gram, panel and QR entries at the shapes
that a cell's step launches, for the per-layer readers to time.
"""

from __future__ import annotations

import gc

import torch

import albatross_tpu_torch as pt
from albatross_tpu_torch.models.sparse_gp import _tall_qr
from albatross_tpu_torch.ops.panel_cholinv import panel_cholinv
from albatross_tpu_torch.ops.radial_gram import radial_gram

# the port's profile name of each radial kernel a configuration may name
PROFILES = {"SquaredExponential": "squared_exponential"}


def radial_plus_noise(config: dict):
    """The radial kernel that ``config["kernel"]`` names plus independent
    measurement noise: the covariance of a model module that defines none."""
    k = config["kernel"]
    return getattr(pt, k["radial"])(k["length_scale"], k["sigma"]) + pt.measurement_only(
        pt.IndependentNoise(k["noise"], assume_unique=k["noise_assume_unique"]))


class Program:
    """One cell's model and training data on the card."""

    def __init__(self, cell, data):
        """``data``: the ``generator.Training`` that the cell's law drew."""
        self.config, self.x = cell.config, data.x
        covariance = getattr(cell.model, "covariance", radial_plus_noise)
        self.model = cell.model.build(self.config, covariance(self.config))
        self.data = pt.RegressionDataset.create(data.x, data.y, data.variance)

    # the port's kernels at a cell's shapes, for the per-layer readers

    def _gram_args(self):
        k = self.config["kernel"]
        return k["length_scale"], k["sigma"], PROFILES[k["radial"]]

    def training_gram(self):
        """The (N, N) training covariance with its noise + jitter diagonal,
        in one launch, as the exact GP's step writes it."""
        ls, sigma, profile = self._gram_args()
        x2 = self.x[:, None].contiguous()
        k = self.config["kernel"]
        diag = torch.full((x2.shape[0],), k["noise"] ** 2 + self.config["jitter"], dtype=x2.dtype, device=x2.device)
        return lambda: radial_gram(x2, x2, ls, sigma, profile, diag_add=diag)

    def cross_gram(self, other: torch.Tensor):
        """The (N, len(other)) cross covariance of the training inputs."""
        ls, sigma, profile = self._gram_args()
        x2, o2 = self.x[:, None].contiguous(), other[:, None].contiguous()
        return lambda: radial_gram(x2, o2, ls, sigma, profile)

    def inducing_points(self) -> torch.Tensor:
        return pt.UniformlySpacedInducingPoints(self.config["inducing_points"])(None, self.x)

    def panel(self, b: int, seed: int):
        """The panel factor + inverse of a seeded SPD (b, b) f32 panel."""
        g = torch.Generator(device=self.x.device)
        g.manual_seed(seed)
        B = torch.randn(b, b, generator=g, device=self.x.device) / b**0.5
        A = B @ B.T + torch.eye(b, device=self.x.device)
        return lambda: panel_cholinv(A)

    def tall_qr(self, rows: int, cols: int, seed: int):
        """The sparse GP's tall QR, reduced mode (as value+grad takes it),
        of a seeded f32 (rows, cols) matrix."""
        g = torch.Generator(device=self.x.device)
        g.manual_seed(seed)
        B = torch.randn(rows, cols, generator=g, device=self.x.device)
        return lambda: _tall_qr(B, "reduced")

    def close(self, *holders) -> None:
        """Free the model and whatever ``holders`` (a loop) keep of it,
        and every cached block on the card."""
        for holder in (self, *holders):
            holder.__dict__.clear()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
