"""The cell ``temperature_f64.tune`` cut to the CPU's size: it runs
correct, its control (the program in float32 on the inputs rounded to
float32) fails the cell's own check, and two faults planted on the
program's side fail it too: the angular exponential's length scale 5%
long, and the elevation scaling dropped."""

import pytest
import torch

from conftest import cpu_run, tiny_cell

import albatross_tpu_torch as pt
from albatross_tpu_torch.temperature import ElevationScalingFunction
from gpbench import calibrate

CELL = "temperature_f64.tune"


def test_the_cell_runs_correct():
    result = cpu_run(tiny_cell(CELL))
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1


def test_its_float32_control_fails_and_the_program_passes():
    cell = tiny_cell(CELL)
    limits = cell.limits["limits"]
    program = calibrate.readings_for(cell, 43, control=False, device="cpu")
    control = calibrate.readings_for(cell, 43, control=True, device="cpu")
    assert all(program[k] <= limit for k, limit in limits.items()), program
    assert any(control[k] > limit for k, limit in limits.items()), control


def _length_scale_off(monkeypatch):
    """The angular exponential's length scale 5% long (the model's one
    Exponential), on the program's side alone."""
    profile = pt.Exponential._profile
    monkeypatch.setattr(pt.Exponential, "_profile",
                        lambda self, distance, length_scale, sigma: profile(self, distance, length_scale * 1.05, sigma))


def _scaling_dropped(monkeypatch):
    """The elevation scaling left out: a scale of 1 at every station."""
    monkeypatch.setattr(ElevationScalingFunction, "_scale",
                        lambda self, X: torch.ones(X.shape[0], dtype=X.dtype, device=X.device))


@pytest.mark.parametrize("fault", [_length_scale_off, _scaling_dropped], ids=lambda f: f.__name__)
def test_a_fault_on_the_programs_side_fails(fault, monkeypatch):
    fault(monkeypatch)
    result = cpu_run(tiny_cell(CELL))
    assert result["correct"] is False
    assert any(row["value"] > row["limit"] for row in result["check"].values()), result["check"]
