"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the repository's root names the cells, their
configurations and traffic mixes, and the metrics.  Each piece is a file
of its own under this folder, found by a name that a data file gives:

* ``configs/<config>.json``: the model's sizes, parameters and data law;
  its ``model`` names the two modules below;
* ``models/<model>.py``: how the port builds that model, and its counts
  and kernel entries for the per-layer readers;
* ``reference/<model>.py``: the plain float64 reference of that model;
* ``traffic/<mix>.json``: the parameters of one mix; its ``kind`` names
  ``kinds/<kind>.py``, the loop that the window runs and the numbers its
  check compares, and a tuning mix's ``objective`` names
  ``objectives/<objective>.py``, the port's objective;
* ``limits/<workload>.json``: the check's limits and sample size;
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx)``.

So a new configuration, model, mix, kind of mix, cell or metric is a new
file and a new entry in ``BENCHMARK.json``, and no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def plugin(folder: str, name: str, here: Path = HERE):
    """The module ``<folder>/<name>.py`` under ``here``, loaded once from
    its path (a metric's name may hold dots)."""
    path = here / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no module {path} for {folder} {name!r}")
    key = f"gpbench_{folder}_{name.replace('.', '_')}_{abs(hash(str(path))):x}"
    if key not in sys.modules:
        module_spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(module_spec)
        sys.modules[key] = module
        try:
            module_spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its pieces loaded."""

    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    here: Path = HERE

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def kind(self):
        """``kinds/<kind>.py``: the window's loop and the check's numbers."""
        return plugin("kinds", self.traffic["kind"], self.here)

    @property
    def model(self):
        """``models/<model>.py``: the port's side of the model."""
        return plugin("models", self.config["model"], self.here)

    @property
    def reference(self):
        """``reference/<model>.py``: the plain float64 side."""
        return plugin("reference", self.config["model"], self.here)

    def objective(self):
        """``objectives/<objective>.py`` of a tuning mix."""
        return plugin("objectives", self.traffic["objective"], self.here)


def reports(metric: dict, workload: str) -> bool:
    """Whether the cell ``workload`` reports the end-to-end ``metric``."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, bench: dict | None = None, here: Path = HERE) -> Cell:
    """The cell called ``name``, its configuration, traffic, limits and the
    metrics it reports: every end-to-end metric that names it or names no
    cell, and every per-layer metric that names it."""
    bench = benchmark() if bench is None else bench
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in bench['workloads']]}")
    workload = matches[0]
    end_to_end = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(workload, load_json(here / "configs" / f"{workload['config']}.json"),
                load_json(here / "traffic" / f"{workload['traffic']}.json"),
                load_json(here / "limits" / f"{name}.json"), end_to_end, per_layer, here)


def reader(metric: str, here: Path = HERE):
    """The reader ``metrics/<metric>.py``."""
    return plugin("metrics", metric, here)
