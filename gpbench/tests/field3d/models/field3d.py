"""An exact GP whose module brings its own covariance, built through the
port's public DSL: a scaling term times a constant, plus measurement
noise, plus the product of two radial terms over different metrics of the
features, an exponential over the horizontal distance of (a, b) and a
squared exponential over the height difference of h.  The shape of
upstream's temperature example, on 3-D points."""

from __future__ import annotations

import dataclasses

import torch

import albatross_tpu_torch as pt
from albatross_tpu_torch.kernels import DistanceMetric


@dataclasses.dataclass(frozen=True)
class Horizontal(DistanceMetric):
    """Euclidean distance of the first two coordinates."""

    @property
    def name(self):
        return "horizontal"

    def pairwise(self, X, Y):
        return torch.sqrt(torch.square(X[:, None, 0] - Y[None, :, 0]) + torch.square(X[:, None, 1] - Y[None, :, 1]))


@dataclasses.dataclass(frozen=True)
class Vertical(DistanceMetric):
    """Difference of the third coordinate."""

    @property
    def name(self):
        return "vertical"

    def pairwise(self, X, Y):
        return torch.abs(X[:, None, 2] - Y[None, :, 2])


class HeightScaling(pt.ScalingFunction):
    """1 + factor max(0, center - h), its parameters fixed."""

    def __init__(self, center: float, factor: float):
        self.height_scaling_center = pt.Parameter(center, pt.FixedPrior())
        self.height_scaling_factor = pt.Parameter(factor, pt.FixedPrior())

    @property
    def name(self):
        return "height_scaled"

    def _scale(self, X):
        return 1.0 + self.height_scaling_factor.value * torch.clamp_min(
            self.height_scaling_center.value - X[:, 2], 0.0)


def covariance(config: dict):
    k = config["kernel"]
    scaled = pt.ScalingTerm(HeightScaling(k["center"], k["factor"])) * pt.Constant(k["sigma_constant"])
    noise = pt.measurement_only(pt.IndependentNoise(k["noise"], assume_unique=True))
    horizontal = pt.Exponential(k["horizontal_length_scale"], k["sigma_horizontal"], distance_metric=Horizontal())
    vertical = pt.SquaredExponential(k["vertical_length_scale"], k["sigma_vertical"], distance_metric=Vertical())
    return scaled + noise + horizontal * vertical


def build(config: dict, kernel):
    """The exact GP, the horizontal term's sigma fixed (the product has one
    scale), as upstream's temperature example fixes its own."""
    return pt.gp_from_covariance(kernel, jitter=config["jitter"]).set_param(
        "sigma_exponential", pt.Parameter(config["kernel"]["sigma_horizontal"], pt.FixedPrior()))
