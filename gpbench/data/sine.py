"""The sine law, the law of a configuration whose ``data`` names none:
1-D inputs drawn uniformly on [low, high] and sorted, targets
sin(frequency x) plus noise times a standard normal, no target variance
(the JAX package's bench law).  A predict mix's batches are ``batch``
inputs uniform on its own [low, high]."""

from __future__ import annotations

import torch

from gpbench import generator


def training_data(config: dict, seed: int, device) -> generator.Training:
    """(x, y) in the configuration's dtype on ``device``, drawn on the
    device in float64."""
    law, n = config["data"], config["n"]
    dtype = getattr(torch, config["dtype"])
    g = generator.device_generator(device, seed, generator.TRAINING)
    x = torch.rand(n, dtype=torch.float64, generator=g, device=device) * (law["high"] - law["low"]) + law["low"]
    x = torch.sort(x).values.to(dtype)
    noise = torch.randn(n, dtype=torch.float64, generator=g, device=device)
    y = (torch.sin(law["frequency"] * x.double()) + law["noise"] * noise).to(dtype)
    return generator.Training(x, y)


def predict_points(config: dict, traffic: dict, seed: int, i: int, device,
                   stream: int = generator.BATCHES) -> torch.Tensor:
    """Batch i of a predict mix: ``batch`` inputs uniform on [low, high],
    in the configuration's dtype."""
    g = generator.device_generator(device, seed, stream, i)
    x = torch.rand(traffic["batch"], dtype=torch.float64, generator=g, device=device)
    return (x * (traffic["high"] - traffic["low"]) + traffic["low"]).to(getattr(torch, config["dtype"]))
