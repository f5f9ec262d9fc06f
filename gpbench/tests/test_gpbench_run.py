"""Whole runs through the harness on the CPU at small sizes: the result
line's keys, the no-JAX check, and the check failing on faults planted in
the program's timed path."""

import json
import math
import subprocess
import sys

import pytest
import torch

from conftest import cpu_run, tiny_cell

import albatross_tpu_torch as pt
from albatross_tpu_torch.core.parameters import ParameterHandlingMixin
from albatross_tpu_torch.evaluation.model_metrics import LeaveOneOutLikelihood
from albatross_tpu_torch.models.gp import GaussianProcess
from albatross_tpu_torch.models.sparse_gp import SparseGaussianProcessRegression
from gpbench import run, spec

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


def test_result_line_has_the_contract_keys(workload):
    cell = tiny_cell(workload)
    result = cpu_run(cell)
    assert set(result) == RESULT_KEYS
    assert list(result)[-1] == "check"
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    for name, row in result["check"].items():
        assert set(row) == {"value", "limit"} and row["value"] <= row["limit"], name
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end} - {"peak_mem_gib"}
    json.loads(json.dumps(result))


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert run.main(["--workload", "exact_se1d.tune", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_nothing_loads_jax():
    """Import every module of the benchmark, each module found by name
    among them, in a fresh process; no loaded module's top-level name is
    JAX's or the JAX package's (the port's name starts with the JAX
    package's and passes)."""
    code = (
        "import sys, pkgutil, importlib, gpbench\n"
        "from gpbench import spec\n"
        "for m in pkgutil.walk_packages(gpbench.__path__, 'gpbench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "for folder in ('kinds', 'models', 'objectives', 'reference', 'metrics'):\n"
        "    for path in sorted((spec.HERE / folder).glob('*.py')): spec.plugin(folder, path.stem)\n"
        "from gpbench import run\n"
        "print(run.forbidden_modules(), 'albatross_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=spec.ROOT, check=True)
    assert out.stdout.split() == ["[]", "True"]


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    monkeypatch.setitem(sys.modules, "albatross_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]


def _state_unchanged(monkeypatch, model_class):
    """A step that leaves the model's parameters as they were: the tunable
    vector reaches the model with no effect on its values."""
    original = ParameterHandlingMixin.set_tunable_params

    def unchanged(self, x, force_bounds=True):
        return original(self, x * 0.0 + self.get_tunable_parameters().values, force_bounds)

    monkeypatch.setattr(ParameterHandlingMixin, "set_tunable_params", unchanged)


def _half_batch(monkeypatch, model_class):
    """Half of the training batch left out, the objective scaled up from
    the rest."""
    target = LeaveOneOutLikelihood if model_class is None else model_class
    name = "__call__" if model_class is None else "log_likelihood"
    original = getattr(target, name)

    def half(self, data, *rest):
        n = data.targets.mean.shape[0] // 2
        return 2.0 * original(self, pt.RegressionDataset.create(data.features[:n], data.targets.mean[:n]), *rest)

    monkeypatch.setattr(target, name, half)


def _altered(monkeypatch, model_class):
    """The answer altered where it is produced: the objective off by one
    part in twenty, which scales its gradient alike."""
    target = LeaveOneOutLikelihood if model_class is None else model_class
    name = "__call__" if model_class is None else "log_likelihood"
    original = getattr(target, name)
    monkeypatch.setattr(target, name, lambda self, *args: original(self, *args) * (1.0 + 5e-2))


def _half_predictions(monkeypatch, model_class):
    """Half of each batch's predictions left out, the mean of the rest put
    in their place."""
    original = GaussianProcess._predict_marginal

    def half(self, features, fit):
        out = original(self, features, fit)
        n = out.mean.shape[0] // 2
        mean = torch.cat([out.mean[:n], out.mean[:n].mean().expand(out.mean.shape[0] - n)])
        return pt.MarginalDistribution(mean, out.variance)

    monkeypatch.setattr(GaussianProcess, "_predict_marginal", half)


def _altered_prediction(monkeypatch, model_class):
    """One predicted mean altered where it is produced."""
    original = GaussianProcess._predict_marginal

    def altered(self, features, fit):
        out = original(self, features, fit)
        return pt.MarginalDistribution(out.mean + torch.nn.functional.one_hot(
            torch.tensor(3), out.mean.shape[0]).to(out.mean) * 0.05, out.variance)

    monkeypatch.setattr(GaussianProcess, "_predict_marginal", altered)


# the faults each cell can have; one chip, so no exchange between chips
FAULTS = {
    "exact_se1d.tune": (GaussianProcess, [_state_unchanged, _half_batch, _altered]),
    "fitc_se1d.tune": (SparseGaussianProcessRegression, [_state_unchanged, _half_batch, _altered]),
    "exact_se1d.loo_tune": (None, [_state_unchanged, _half_batch, _altered]),
    "exact_se1d.predict": (GaussianProcess, [_half_predictions, _altered_prediction]),
}


@pytest.mark.parametrize("name,fault", [(name, fault) for name, (_, faults) in FAULTS.items() for fault in faults],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_fault_in_the_timed_path_fails_the_check(monkeypatch, name, fault):
    cell = tiny_cell(name)
    fault(monkeypatch, FAULTS[name][0])
    result = cpu_run(cell)
    assert result["correct"] is False
    assert any(not math.isfinite(r["value"]) or r["value"] > r["limit"] for r in result["check"].values())
