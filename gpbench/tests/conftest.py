"""Shared pieces of the benchmark's tests: cells cut to a size the CPU
runs in a second, and a CPU run of a cell through the harness."""

import json
import shutil
import time

import pytest

from gpbench import run, spec

TINY = {"n": 384, "inducing_points": 48}


def tiny_cell(name: str) -> spec.Cell:
    """The cell ``name`` with its sizes cut for the CPU; every limit and
    every other setting as the benchmark has them."""
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, **{k: v for k, v in TINY.items() if k in cell.config})
    if "batch" in cell.traffic:
        cell.traffic = dict(cell.traffic, batch=64)
    return cell


def copy_harness(tmp_path) -> tuple:
    """(a copy of the harness under ``tmp_path``, without its tests, and a
    copy of BENCHMARK.json's entries), for tests that add pieces to both."""
    here = tmp_path / "gpbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return here, json.loads(json.dumps(spec.benchmark()))


def cpu_run(cell: spec.Cell, seed: int = 2**31 + 17, seconds: float = 1.0) -> dict:
    return run.run_cell(cell, seed, seconds, False, "cpu", time.perf_counter())[0]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: at these sizes more threads gain nothing,
    and on a loaded host, or under several test workers, they can crowd a
    cell's every step out of a one-second window."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=[w["name"] for w in spec.benchmark()["workloads"]])
def workload(request):
    return request.param
