"""Every piece of BENCHMARK.json is found by name, and new pieces, a new
kind of traffic among them, are new files that the harness picks up with
no edit."""

import json
import shutil
import time

from conftest import tiny_cell

from gpbench import run, spec

BENCH = spec.benchmark()


def test_every_piece_is_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert callable(cell.kind.Loop) and callable(cell.kind.readings) and callable(cell.model.build)
    assert cell.end_to_end and cell.per_layer
    assert {"setup_s", "peak_mem_gib"} <= {m["name"] for m in cell.end_to_end}
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(metric["name"]).read)
    for metric in cell.per_layer:
        assert metric["moves"] in {m["name"] for m in cell.end_to_end}


def test_configs_are_their_files():
    for config in BENCH["configs"]:
        held = spec.load_json(spec.ROOT / config["file"])
        assert held["name"] == config["name"] and held["source"] == config["source"]
        assert held["reduced"] == config["reduced"]


def _copy(tmp_path):
    here = tmp_path / "gpbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return here, json.loads(json.dumps(BENCH))


def _run(bench, here, name):
    cell = spec.load_cell(name, bench, here)
    return cell, run.run_cell(cell, 5, 1.0, False, "cpu", time.perf_counter())[0]


def test_new_files_beside_the_others_are_picked_up(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a metric reader,
    each only a new file, run through the harness unchanged."""
    here, bench = _copy(tmp_path)
    config = json.loads((here / "configs" / "exact_se1d.json").read_text())
    config.update(name="exact_wide", n=256, kernel=dict(config["kernel"], length_scale=2.0, noise=0.5))
    (here / "configs" / "exact_wide.json").write_text(json.dumps(config))
    (here / "traffic" / "wide_tune.json").write_text(json.dumps({"kind": "tune", "objective": "nlml", "spread": 0.3}))
    (here / "limits" / "exact_wide.wide_tune.json").write_text(json.dumps(
        {"samples": 2, "limits": {"value": 3e-5, "gradient": 2e-5}}))
    (here / "metrics" / "steps_in_window.py").write_text("def read(ctx):\n    return len(ctx.window.completed)\n")
    bench["workloads"].append({"name": "exact_wide.wide_tune", "config": "exact_wide", "traffic": "wide_tune",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "steps_in_window", "unit": "steps", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["exact_wide.wide_tune"]})
    cell, result = _run(bench, here, "exact_wide.wide_tune")
    assert cell.traffic["spread"] == 0.3 and cell.config["kernel"]["length_scale"] == 2.0
    assert result["correct"], result["check"]
    assert result["metrics"]["steps_in_window"]["value"] >= 1
    assert result["metrics"]["steps_in_window"]["unit"] == "steps"


# a kind of traffic the benchmark does not have: refits of the model on a
# growing prefix of the training set, checked by each fit's log likelihood
REFIT_KIND = '''
import torch

import albatross_tpu_torch as pt
from gpbench.check import worst


class Loop:
    def __init__(self, cell, program, seed):
        self.model, self.x, self.y = program.model, program.x, program.data.targets.mean
        self.first = cell.traffic["first"]

    def inputs(self, i, stream=0):
        return self.first + i % 4

    def step(self, n):
        data = pt.RegressionDataset.create(self.x[:n], self.y[:n])
        return n, self.model.log_likelihood(data).item()

    @staticmethod
    def finite(answer):
        return answer[1] == answer[1]


def readings(cell, x, y, answers, sample, seed, detail=None):
    params = {k: torch.tensor(cell.config["kernel"][k], dtype=torch.float64)
              for k in ("length_scale", "sigma", "noise")}
    gaps = []
    for i in sample:
        n, value = answers[i]
        ref = -cell.reference.nlml(x[:n].double(), y[:n].double(), params, cell.config).item()
        gaps.append(abs(value - ref) / abs(ref))
    return {"log_likelihood": worst(gaps)}
'''


def test_a_new_kind_of_traffic_is_new_files(tmp_path):
    """A kind of traffic that the harness has never run: its loop and its
    check in ``kinds/<kind>.py``, its parameters in a data file."""
    here, bench = _copy(tmp_path)
    (here / "kinds" / "refit.py").write_text(REFIT_KIND)
    (here / "traffic" / "refit.json").write_text(json.dumps({"kind": "refit", "first": 200}))
    (here / "limits" / "exact_se1d.refit.json").write_text(json.dumps(
        {"samples": 3, "limits": {"log_likelihood": 2e-5}}))
    (here / "metrics" / "refits_per_s.py").write_text(
        "def read(ctx):\n    return ctx.steps_per_s() if ctx.kind == 'refit' else None\n")
    bench["workloads"].append({"name": "exact_se1d.refit", "config": "exact_se1d", "traffic": "refit",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "refits_per_s", "unit": "fits/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["exact_se1d.refit"]})
    cell, result = _run(bench, here, "exact_se1d.refit")
    assert result["correct"], result["check"]
    assert set(result["check"]) == {"log_likelihood"}
    assert result["metrics"]["refits_per_s"]["value"] > 0


def test_tiny_cells_keep_every_other_setting(workload):
    cell = tiny_cell(workload)
    full = spec.load_cell(workload)
    assert cell.limits == full.limits
    assert {k: v for k, v in cell.config.items() if k not in ("n", "inducing_points")} == \
        {k: v for k, v in full.config.items() if k not in ("n", "inducing_points")}
