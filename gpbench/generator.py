"""The streams that every input of a cell is drawn from, made from ``--seed``.

A configuration's data law (``data/<law>.py``) draws the training set from
the stream TRAINING and a predict mix's batches from BATCHES.  This module
draws what the other kinds of mix send, the tunable vectors a tuner
visits, each entry within +-``spread`` of the configuration's value, and
the sample of answers that the check compares.
Each stream draws from its own seed, derived from ``--seed`` and the
stream's number, so the same seed gives the same inputs in any order of
use, and the reference can make any batch again.  Every seed gives the
same sizes, so the seed changes the values and never the work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpbench import spec

TRAINING, TUNABLE, BATCHES, WARMUP, CHECK_SAMPLE = range(5)


class Training(NamedTuple):
    """A training set as a data law draws it: inputs, (N,) or (N, D),
    targets (N,), and each target's variance (N,), or None where the law
    gives none.  The program and the reference are handed the same."""

    x: torch.Tensor
    y: torch.Tensor
    variance: torch.Tensor | None = None

    def to(self, dtype: torch.dtype) -> Training:
        return Training(*(None if t is None else t.to(dtype) for t in self))


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of ``seed``: any whole number of any
    size maps to one."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def device_generator(device, seed: int, *stream: int) -> torch.Generator:
    """A torch generator on ``device`` seeded for one stream of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *stream))
    return g


def tunable_vector(x0: np.ndarray, traffic: dict, seed: int, i: int, stream: int = TUNABLE) -> np.ndarray:
    """The i-th tunable vector of a tuning mix: each entry of ``x0`` times
    1 + spread u, u uniform on [-1, 1]."""
    u = np.random.default_rng(stream_seed(seed, stream, i)).uniform(-1.0, 1.0, x0.shape[0])
    return x0 * (1.0 + traffic["spread"] * u)


def predict_points(config: dict, traffic: dict, seed: int, i: int, device, stream: int = BATCHES) -> torch.Tensor:
    """Batch i of a predict mix, as the configuration's data law under this
    folder draws it (for readers that are handed no cell)."""
    return spec.data_law(config).predict_points(config, traffic, seed, i, device, stream)


def check_sample(seed: int, population: int, count: int) -> list[int]:
    """``count`` distinct indices of ``population`` answers, drawn from the
    seed, in increasing order; the last answer is always among them."""
    if population <= count:
        return list(range(population))
    rng = np.random.default_rng(stream_seed(seed, CHECK_SAMPLE))
    rest = rng.choice(population - 1, size=count - 1, replace=False)
    return sorted(int(i) for i in rest) + [population - 1]
