"""Shared pieces of the benchmark's tests: cells cut to a size the CPU
runs in a second, and a CPU run of a cell through the harness."""

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


def cpu_run(cell: spec.Cell, seed: int = 2**31 + 17, seconds: float = 1.0) -> dict:
    return run.run_cell(cell, seed, seconds, False, "cpu", time.perf_counter())[0]


@pytest.fixture(params=[w["name"] for w in spec.benchmark()["workloads"]])
def workload(request):
    return request.param
