"""The temperature-field example through the port's API.

    python -m albatross_tpu_torch.temperature [--stations 120] [--device cpu]

A GP over weather stations with the composed covariance

    elevation_scaled(Constant) + measurement_only(IndependentNoise)
    + Exponential[angular] * SquaredExponential[radial]

over (ECEF x, y, z, elevation) station rows: the angular term decays with
great-circle separation, the radial term with height difference, and the
elevation scaling biases the constant colder at altitude.  The stations
are synthesized from a ground-truth field (a latitudinal gradient, a
longitudinal wave and the lapse rate), as the JAX package's
``examples/temperature.py`` does with the same numpy draws.  The example
prints the LOO skill, a prediction on a sea-level grid, and which injected
outliers RANSAC rejects.  It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .core import FixedPrior, Parameter, RegressionDataset
from .indexing import LeaveOneOutGrouper
from .kernels import (
    AngularDistance,
    Constant,
    DistanceMetric,
    Exponential,
    IndependentNoise,
    RadialDistance,
    ScalingFunction,
    ScalingTerm,
    SquaredExponential,
    measurement_only,
)
from .models import DefaultGPRansacStrategy, GaussianProcess, RansacConfig, gp_from_covariance, ransac_success

EARTH_RADIUS = 6371e3


@dataclasses.dataclass(frozen=True)
class StationDistance(DistanceMetric):
    """An inner metric applied to the ECEF block of station rows."""

    inner: DistanceMetric

    @property
    def name(self):
        return f"station[{self.inner.name}]"

    def pairwise(self, X, Y):
        return self.inner.pairwise(X[:, :3], Y[:, :3])

    def diag(self, X):
        return self.inner.diag(X[:, :3])


class ElevationScalingFunction(ScalingFunction):
    """1 + factor * max(0, center - elevation)."""

    def __init__(self, center=1000.0, factor=3.5 / 300.0):
        self.elevation_scaling_center = Parameter(center, FixedPrior())
        self.elevation_scaling_factor = Parameter(factor, FixedPrior())

    @property
    def name(self):
        return "elevation_scaled"

    def _scale(self, X):
        below = torch.clamp_min(self.elevation_scaling_center.value - X[:, 3], 0.0)
        return 1.0 + self.elevation_scaling_factor.value * below


def lla_to_station(lat_deg, lon_deg, elevation) -> np.ndarray:
    """(N, 4) station rows [x, y, z, elevation] from latitude, longitude
    (degrees) and elevation (metres)."""
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    r = EARTH_RADIUS + elevation
    return np.stack([r * np.cos(lat) * np.cos(lon), r * np.cos(lat) * np.sin(lon), r * np.sin(lat), elevation],
                    axis=1)


def synthesize_stations(n: int, rng):
    """(stations, observations, truth): n stations over the south-western
    United States; truth is a latitudinal gradient, a longitudinal wave and
    the standard lapse rate, observations add unit noise."""
    lat = rng.uniform(32.0, 42.0, n)
    lon = rng.uniform(-115.0, -100.0, n)
    elevation = np.abs(rng.normal(800.0, 700.0, n))
    truth = 25.0 - 0.7 * (lat - 32.0) + 2.0 * np.sin(np.radians(8.0 * lon)) - 6.5e-3 * elevation
    obs = truth + rng.normal(0.0, 1.0, n)
    return lla_to_station(lat, lon, elevation), obs, truth


def sea_level_grid(n_lat: int, n_lon: int) -> np.ndarray:
    """Station rows on an n_lat x n_lon sea-level grid over the stations'
    region."""
    glat, glon = np.meshgrid(np.linspace(32, 42, n_lat), np.linspace(-115, -100, n_lon))
    return lla_to_station(glat.ravel(), glon.ravel(), np.zeros(glat.size))


def build_model() -> GaussianProcess:
    """The reference example's model, with sigma_exponential fixed (it is
    already tuned there)."""
    elevation_scaled_mean = ScalingTerm(ElevationScalingFunction()) * Constant(1.5)
    radial_sqr_exp = SquaredExponential(15000.0, 2.5, distance_metric=StationDistance(RadialDistance()))
    angular_exp = Exponential(9e-2, 3.5, distance_metric=StationDistance(AngularDistance()))
    covariance = elevation_scaled_mean + measurement_only(IndependentNoise(2.0)) + angular_exp * radial_sqr_exp
    return gp_from_covariance(covariance).set_param("sigma_exponential", Parameter(3.5, FixedPrior()))


def inject_outliers(obs: np.ndarray, count: int, rng):
    """(observations with ``count`` of them moved by +-15-25, their
    indices)."""
    bad = np.asarray(obs).copy()
    idx = rng.choice(bad.shape[0], count, replace=False)
    bad[idx] += rng.choice([-1, 1], count) * rng.uniform(15.0, 25.0, count)
    return bad, idx


def ransac_config(n: int, iterations: int) -> RansacConfig:
    """The reference example's RANSAC configuration for n stations."""
    return RansacConfig(inlier_threshold=4.0, random_sample_size=8, min_consensus_size=int(0.7 * n),
                        max_iterations=iterations, max_failed_candidates=iterations)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--stations", type=int, default=120)
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    rng = np.random.default_rng(11)
    stations, obs, _ = synthesize_stations(args.stations, rng)
    data = RegressionDataset.create(stations, obs, variance=np.ones(args.stations), device=args.device)
    model = build_model()
    print(f"kernel: {model.covariance_function.name}")

    marginal = model.cross_validate().predict(data, LeaveOneOutGrouper()).marginal()
    loo_rmse = float(torch.sqrt(torch.mean((marginal.mean - data.targets.mean) ** 2)))
    climatology_rmse = float(torch.std(data.targets.mean, correction=0))
    print(f"LOO RMSE: {loo_rmse:.3f} C  (climatology {climatology_rmse:.3f})")

    grid = torch.as_tensor(sea_level_grid(12, 12), device=data.features.device)
    pred = model.fit(data).predict(grid).marginal()
    print(f"grid prediction range: [{float(pred.mean.min()):.1f}, {float(pred.mean.max()):.1f}] C, "
          f"mean stddev {float(torch.sqrt(pred.variance).mean()):.2f}")
    if not loo_rmse < climatology_rmse:
        raise RuntimeError("the GP should beat climatology")

    bad, bad_idx = inject_outliers(obs, 4, rng)
    contaminated = RegressionDataset.create(stations, bad, variance=np.ones(args.stations), device=args.device)
    rfit = model.ransac(DefaultGPRansacStrategy(), ransac_config(args.stations, 12)).fit(contaminated)
    out = rfit.fit.ransac_output
    rejected = sorted(set(range(args.stations)) - set(out.best.consensus()))
    print(f"RANSAC: {out.return_code.name}, rejected stations {rejected} "
          f"(injected outliers at {sorted(int(i) for i in bad_idx)})")
    caught = set(int(i) for i in bad_idx) & set(rejected)
    if not (ransac_success(out.return_code) and len(caught) >= 3):
        raise RuntimeError(f"RANSAC caught only {sorted(caught)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
