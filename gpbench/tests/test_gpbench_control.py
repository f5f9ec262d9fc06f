"""On the card: the control, the program in the precision below the
configuration's (a float32 configuration's with its TF32 path on, a
float64 one's in float32), fails the check at the cell's own size, while
the program as configured passes.
Run on the card: python -m pytest -p no:cacheprovider gpbench/tests/test_gpbench_control.py"""

import pytest

from gpbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_fails_and_the_program_passes(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the control runs at the cell's own size")
    from gpbench import calibrate

    cell = spec.load_cell(name)
    seed = 2**31 + 101
    limits = cell.limits["limits"]
    program = calibrate.readings_for(cell, seed, control=False)
    control = calibrate.readings_for(cell, seed, control=True)
    assert all(program[k] <= limit for k, limit in limits.items()), program
    assert any(control[k] > limit for k, limit in limits.items()), control
