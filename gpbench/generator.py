"""The one traffic generator: every input of a cell, made from ``--seed``.

A configuration's ``data`` law gives the training set; a traffic file
gives what the window sends, which its kind's loop (``kinds/``) draws
here: the tunable vectors a tuner visits, each entry within +-``spread``
of the configuration's value, or batches of ``batch`` fresh inputs on
[low, high].
Each stream draws from its own seed, derived from ``--seed`` and the
stream's number, so the same seed gives the same inputs in any order of
use, and the reference can make any batch again.  Every seed gives the
same sizes, so the seed changes the values and never the work.
"""

from __future__ import annotations

import numpy as np
import torch

TRAINING, TUNABLE, BATCHES, WARMUP, CHECK_SAMPLE = range(5)


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of ``seed``: any whole number of any
    size maps to one."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _generator(device, seed: int, *stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *stream))
    return g


def training_data(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, y) in the configuration's dtype on ``device``: n inputs drawn
    uniformly on [low, high] and sorted, targets sin(frequency x) plus
    noise times a standard normal, drawn on the device in float64."""
    law, n = config["data"], config["n"]
    dtype = getattr(torch, config["dtype"])
    g = _generator(device, seed, TRAINING)
    x = torch.rand(n, dtype=torch.float64, generator=g, device=device) * (law["high"] - law["low"]) + law["low"]
    x = torch.sort(x).values.to(dtype)
    noise = torch.randn(n, dtype=torch.float64, generator=g, device=device)
    y = (torch.sin(law["frequency"] * x.double()) + law["noise"] * noise).to(dtype)
    return x, y


def tunable_vector(x0: np.ndarray, traffic: dict, seed: int, i: int, stream: int = TUNABLE) -> np.ndarray:
    """The i-th tunable vector of a tuning mix: each entry of ``x0`` times
    1 + spread u, u uniform on [-1, 1]."""
    u = np.random.default_rng(stream_seed(seed, stream, i)).uniform(-1.0, 1.0, x0.shape[0])
    return x0 * (1.0 + traffic["spread"] * u)


def predict_points(config: dict, traffic: dict, seed: int, i: int, device, stream: int = BATCHES) -> torch.Tensor:
    """Batch i of a predict mix: ``batch`` inputs uniform on [low, high],
    in the configuration's dtype."""
    g = _generator(device, seed, stream, i)
    x = torch.rand(traffic["batch"], dtype=torch.float64, generator=g, device=device)
    return (x * (traffic["high"] - traffic["low"]) + traffic["low"]).to(getattr(torch, config["dtype"]))


def check_sample(seed: int, population: int, count: int) -> list[int]:
    """``count`` distinct indices of ``population`` answers, drawn from the
    seed, in increasing order; the last answer is always among them."""
    if population <= count:
        return list(range(population))
    rng = np.random.default_rng(stream_seed(seed, CHECK_SAMPLE))
    rest = rng.choice(population - 1, size=count - 1, replace=False)
    return sorted(int(i) for i in rest) + [population - 1]
