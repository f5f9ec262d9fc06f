"""The upstream temperature model (swift-nav/albatross
``examples/temperature_example``) as the port builds it: its covariance
through the port's public DSL, over the port's own station metrics and
elevation scaling (``albatross_tpu_torch.temperature``), and the exact GP
with ``sigma_exponential`` fixed; the benchmark's operation count of a
value+grad step and the bytes that bound its covariance."""

from __future__ import annotations

import torch

import albatross_tpu_torch as pt
from albatross_tpu_torch.temperature import ElevationScalingFunction, StationDistance
from gpbench import counts


def covariance(config: dict):
    """elevation_scaled(Constant) + measurement_only(IndependentNoise)
    + Exponential[station[angular]] * SquaredExponential[station[radial]];
    the noise compares rows, as upstream's does."""
    k = config["kernel"]
    scaling = ElevationScalingFunction(k["elevation_scaling_center"], k["elevation_scaling_factor"])
    elevation_scaled = pt.ScalingTerm(scaling) * pt.Constant(k["sigma_constant"])
    noise = pt.measurement_only(pt.IndependentNoise(k["sigma_independent_noise"]))
    angular = pt.Exponential(k["exponential_length_scale"], k["sigma_exponential"],
                             distance_metric=StationDistance(pt.AngularDistance()))
    radial = pt.SquaredExponential(k["squared_exponential_length_scale"], k["sigma_squared_exponential"],
                                   distance_metric=StationDistance(pt.RadialDistance()))
    return elevation_scaled + noise + angular * radial


def build(config: dict, kernel):
    """The exact GP, ``sigma_exponential`` fixed (the product has one
    scale), as the port's ``temperature.build_model`` fixes it."""
    return pt.gp_from_covariance(kernel, jitter=config["jitter"]).set_param(
        "sigma_exponential", pt.Parameter(config["kernel"]["sigma_exponential"], pt.FixedPrior()))


def value_grad_flops(config: dict, objective: str) -> float:
    if objective != "nlml":
        raise ValueError(f"no operation count of the objective {objective!r} for this model")
    return counts.exact_value_grad_flops(config["n"])


def covariance_bytes(config: dict) -> float:
    """The least bytes of the covariance layer a value+grad step: the
    (N, N) training covariance written once forward and its gradient read
    once backward; the (N, 4) rows are negligible."""
    itemsize = torch.finfo(getattr(torch, config["dtype"])).bits // 8
    return 2.0 * itemsize * config["n"] ** 2
