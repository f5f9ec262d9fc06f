"""Weather stations over the south-western United States, the law of
upstream's temperature example as the port synthesizes it
(``albatross_tpu_torch/temperature.py`` ``synthesize_stations``):
latitude uniform on ``lat`` degrees, longitude uniform on ``lon``,
elevation |N(elevation_mean, elevation_sd^2)| metres; each row is
(ECEF x, y, z, elevation) on a sphere of radius ``earth_radius`` plus the
elevation (``lla_to_station``'s formula).  The targets are a ground truth
(a latitudinal gradient, a longitudinal wave and the standard lapse rate)
plus N(0, noise_sd^2) noise, and each target's variance is noise_sd^2.
A predict mix's batches are ``batch`` sea-level rows uniform over the
same box."""

from __future__ import annotations

import torch

from gpbench import generator


def _uniform(n: int, bounds, g, device) -> torch.Tensor:
    low, high = bounds
    return low + (high - low) * torch.rand(n, dtype=torch.float64, generator=g, device=device)


def _rows(lat_deg, lon_deg, elevation, earth_radius: float) -> torch.Tensor:
    """(N, 4) rows [x, y, z, elevation] in float64."""
    lat, lon = torch.deg2rad(lat_deg), torch.deg2rad(lon_deg)
    r = earth_radius + elevation
    return torch.stack([r * torch.cos(lat) * torch.cos(lon), r * torch.cos(lat) * torch.sin(lon),
                        r * torch.sin(lat), elevation], dim=1)


def training_data(config: dict, seed: int, device) -> generator.Training:
    law, n = config["data"], config["n"]
    g = generator.device_generator(device, seed, generator.TRAINING)
    lat = _uniform(n, law["lat"], g, device)
    lon = _uniform(n, law["lon"], g, device)
    elevation = torch.abs(law["elevation_mean"]
                          + law["elevation_sd"] * torch.randn(n, dtype=torch.float64, generator=g, device=device))
    truth = 25.0 - 0.7 * (lat - 32.0) + 2.0 * torch.sin(torch.deg2rad(8.0 * lon)) - 6.5e-3 * elevation
    noise = torch.randn(n, dtype=torch.float64, generator=g, device=device)
    y = truth + law["noise_sd"] * noise
    variance = torch.full_like(y, law["noise_sd"] ** 2)
    return generator.Training(_rows(lat, lon, elevation, law["earth_radius"]), y, variance).to(
        getattr(torch, config["dtype"]))


def predict_points(config: dict, traffic: dict, seed: int, i: int, device,
                   stream: int = generator.BATCHES) -> torch.Tensor:
    law, batch = config["data"], traffic["batch"]
    g = generator.device_generator(device, seed, stream, i)
    lat, lon = _uniform(batch, law["lat"], g, device), _uniform(batch, law["lon"], g, device)
    sea_level = torch.zeros(batch, dtype=torch.float64, device=device)
    return _rows(lat, lon, sea_level, law["earth_radius"]).to(getattr(torch, config["dtype"]))
