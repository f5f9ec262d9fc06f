"""A configuration that the benchmark's own cells do not resemble, brought
as new files only: a float64 model over 3-D points with a variance on each
target, its own data law, its own covariance (a product of two radial
terms over different metrics of the features, a scaling term and
measurement noise), its float64 reference, a tune mix, a predict mix and
limits.  The files lie in ``field3d/`` as they would lie under
``gpbench/``; each is new there, and the harness runs them unchanged."""

import shutil
from pathlib import Path

import pytest
import torch

from conftest import copy_harness, cpu_run

import albatross_tpu_torch as pt
from gpbench import calibrate, spec

NEW = Path(__file__).resolve().parent / "field3d"
CELLS = {"field3d.field3d_tune": "field3d_tune", "field3d.field3d_predict": "field3d_predict"}
# the end-to-end metrics of each kind that a new cell names itself in
REPORTS = {"field3d_tune": ["tune_evals_per_s"], "field3d_predict": ["predict_points_per_s", "predict_p95_ms"]}


def copy_with_new_files(tmp_path) -> tuple[Path, dict]:
    """A copy of the harness with the new files added beside its own (none
    replaced), and BENCHMARK.json's entries for them."""
    here, bench = copy_harness(tmp_path)
    for path in sorted(NEW.rglob("*.*")):
        if path.parent.name == "__pycache__":
            continue
        target = here / path.relative_to(NEW)
        assert not target.exists(), f"{target} is not a new file"
        shutil.copyfile(path, target)
    config = spec.load_json(here / "configs" / "field3d.json")
    bench["configs"].append({"name": "field3d", "source": config["source"], "file": "gpbench/configs/field3d.json",
                             "reduced": [], "why": "a test"})
    for name, traffic in CELLS.items():
        bench["workloads"].append({"name": name, "config": "field3d", "traffic": traffic, "chips": 1, "why": "a test"})
        for metric in bench["end_to_end"]:
            if metric["name"] in REPORTS[traffic]:
                metric["workloads"].append(name)
    return here, bench


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return copy_with_new_files(tmp_path_factory.mktemp("newconfig"))


def load(harness, name):
    here, bench = harness
    return spec.load_cell(name, bench, here)



def test_the_law_draws_features_and_a_variance_by_the_seed(harness):
    cell = load(harness, "field3d.field3d_tune")
    data = cell.law.training_data(cell.config, 3, "cpu")
    again = cell.law.training_data(cell.config, 3, "cpu")
    assert data.x.shape == (256, 3) and data.y.shape == data.variance.shape == (256,)
    assert all(a.dtype == torch.float64 for a in data)
    assert all((a == b).all() for a, b in zip(data, again))
    other = cell.law.training_data(cell.config, 4, "cpu")
    assert not (data.x == other.x).all() and other.x.shape == data.x.shape


@pytest.mark.parametrize("name", CELLS)
def test_a_float64_configuration_brought_as_new_files_runs_correct(harness, name):
    cell = load(harness, name)
    result = cpu_run(cell)
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == set(REPORTS[cell.workload["traffic"]]) | {"setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_its_control_in_float32_fails_and_the_program_passes(harness, name):
    """A float64 configuration's control is the program in float32 with
    TF32 off; it fails the cell's own check, the program does not."""
    cell = load(harness, name)
    limits = cell.limits["limits"]
    program = calibrate.readings_for(cell, 41, control=False, device="cpu")
    control = calibrate.readings_for(cell, 41, control=True, device="cpu")
    assert all(program[k] <= limit for k, limit in limits.items()), program
    assert any(control[k] > limit for k, limit in limits.items()), control


def _length_scale_off(monkeypatch):
    """The squared exponential factor's length scale 5% long on the
    program's side alone."""
    profile = pt.SquaredExponential._profile
    monkeypatch.setattr(pt.SquaredExponential, "_profile",
                        lambda self, distance, length_scale, sigma: profile(self, distance, length_scale * 1.05, sigma))


def _variance_dropped(monkeypatch):
    """The program handed the training set without its targets' variance."""
    create = pt.RegressionDataset.create.__func__
    monkeypatch.setattr(pt.RegressionDataset, "create",
                        classmethod(lambda cls, x, y, variance=None, **kw: create(cls, x, y, None, **kw)))


# the log likelihood adds no target variance (upstream's), so only a fit shows the second
FAULTS = [("field3d.field3d_tune", _length_scale_off), ("field3d.field3d_predict", _length_scale_off),
          ("field3d.field3d_predict", _variance_dropped)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_fault_on_the_programs_side_fails(harness, name, fault, monkeypatch):
    cell = load(harness, name)
    fault(monkeypatch)
    result = cpu_run(cell)
    assert result["correct"] is False
    assert any(row["value"] > row["limit"] for row in result["check"].values()), result["check"]
