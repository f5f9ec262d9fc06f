"""The data of the benchmark's own cells have not moved: at the tiny
sizes of the CPU tests and two fixed seeds, the training inputs, the
targets and the first input of each cell's loop (a tunable vector or a
predict batch) hash to what the harness drew before the data laws became
files of their own (``data/``)."""

import hashlib

import numpy as np
import pytest
import torch

from conftest import tiny_cell

from gpbench.program import Program

# (x, y, the loop's first input): sha256 of the raw bytes, first 16 hex digits
DIGESTS = {
    ("exact_se1d.tune", 7): ("62ae52c4dba723da", "59a861f5d88c2ce0", "c11c7da4af6d88ef"),
    ("exact_se1d.tune", 2147483665): ("b2af2baf20077e8f", "fce7a0f12e627a91", "fb2a6696d0dd4fda"),
    ("exact_se1d.predict", 7): ("62ae52c4dba723da", "59a861f5d88c2ce0", "57c77fab496dc9cd"),
    ("exact_se1d.predict", 2147483665): ("b2af2baf20077e8f", "fce7a0f12e627a91", "7e8f93d6ea1b9af3"),
    ("fitc_se1d.tune", 7): ("62ae52c4dba723da", "59a861f5d88c2ce0", "d11d9bf132c8209e"),
    ("fitc_se1d.tune", 2147483665): ("b2af2baf20077e8f", "fce7a0f12e627a91", "bf7e952b0159c9f9"),
    ("exact_se1d.loo_tune", 7): ("62ae52c4dba723da", "59a861f5d88c2ce0", "c11c7da4af6d88ef"),
    ("exact_se1d.loo_tune", 2147483665): ("b2af2baf20077e8f", "fce7a0f12e627a91", "fb2a6696d0dd4fda"),
}


def digest(values) -> str:
    array = values.numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
    return hashlib.sha256(array.tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name,seed", list(DIGESTS), ids=lambda v: str(v))
def test_the_data_have_not_moved(name, seed):
    cell = tiny_cell(name)
    data = cell.law.training_data(cell.config, seed, "cpu")
    assert data.variance is None
    loop = cell.kind.Loop(cell, Program(cell, data), seed)
    assert (digest(data.x), digest(data.y), digest(loop.inputs(0))) == DIGESTS[name, seed]
