"""A field over 3-D points (a, b, h) with a variance on each target: n
points uniform in the box [low, high] (one bound a coordinate), targets
sin(a) cos(b) + slope h plus noise whose standard deviation is drawn for
each point from [noise_low, noise_high]; the variance given is that
noise's.  A predict mix's batches are ``batch`` points uniform in its own
box."""

from __future__ import annotations

import torch

from gpbench import generator


def _box(n: int, low, high, g, device) -> torch.Tensor:
    low, high = (torch.tensor(v, dtype=torch.float64, device=device) for v in (low, high))
    return low + (high - low) * torch.rand(n, len(low), dtype=torch.float64, generator=g, device=device)


def training_data(config: dict, seed: int, device) -> generator.Training:
    law, n = config["data"], config["n"]
    g = generator.device_generator(device, seed, generator.TRAINING)
    x = _box(n, law["low"], law["high"], g, device)
    sd = law["noise_low"] + (law["noise_high"] - law["noise_low"]) * torch.rand(
        n, dtype=torch.float64, generator=g, device=device)
    noise = torch.randn(n, dtype=torch.float64, generator=g, device=device)
    y = torch.sin(x[:, 0]) * torch.cos(x[:, 1]) + law["slope"] * x[:, 2] + sd * noise
    dtype = getattr(torch, config["dtype"])
    return generator.Training(x.to(dtype), y.to(dtype), (sd * sd).to(dtype))


def predict_points(config: dict, traffic: dict, seed: int, i: int, device,
                   stream: int = generator.BATCHES) -> torch.Tensor:
    g = generator.device_generator(device, seed, stream, i)
    return _box(traffic["batch"], traffic["low"], traffic["high"], g, device).to(getattr(torch, config["dtype"]))
