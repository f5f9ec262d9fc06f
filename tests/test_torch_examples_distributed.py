"""Port parity of the distributed example
(``albatross_tpu_torch.examples.distributed``) against the JAX package's
``examples/distributed.py``, f64 on the CPU.

The JAX example runs on the 8 virtual CPU devices of tests/conftest.py;
the port's spawns a gloo world of 8 processes (the example's own
``spawn_world``), each with a (4, 2) ("data", "model") mesh.  The printed
text is held line by line (tests/printed_numbers.py); the differences from
the single process (max|Δmean|, about 1e-14 in f64) are rounding residues,
held below 1e-10 on both sides.  A separate test reads every rank's tile.
"""

import importlib
import sys

import pytest
import torch

from printed_numbers import assert_same_print

torch.set_num_threads(2)
N = 128


@pytest.fixture(scope="module")
def port_world():
    """The port example's result on its spawned world of 8 ranks, and the
    text its ``main`` prints from it."""
    from albatross_tpu_torch.examples import distributed

    return distributed.run(N, 8, device="cpu")


def test_distributed_prints_what_jax_prints(port_world, capsys, monkeypatch):
    from albatross_tpu_torch.examples import distributed

    jax_example = importlib.import_module("examples.distributed")
    old = sys.argv
    sys.argv = ["examples.distributed", "--n", str(N)]
    try:
        assert jax_example.main() == 0
    finally:
        sys.argv = old
    want = capsys.readouterr().out
    # the port's main prints the fixture's world instead of spawning another
    monkeypatch.setattr(distributed, "run", lambda n, ranks, device: port_world)
    assert distributed.main(["--n", str(N), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    residues = {i: 1e-10 for i, line in enumerate(want.splitlines()) if "Δmean" in line}
    assert len(residues) == 4
    assert_same_print(want, got, noise=residues)


def test_every_rank_holds_its_tile_of_the_4x2_mesh(port_world):
    assert port_world["ok"]
    assert port_world["tiles"] == [(N // 4, N // 2)] * 8
    for key in ("mean_err_1d", "mean_err_2d", "update_err", "sparse_mean_err"):
        assert port_world[key] < 1e-10, key
    assert port_world["launches"].keys() >= {"radial_gram", "radial_gram_diag", "panel_cholinv"}


def test_mesh_shape_by_rank_count():
    from albatross_tpu_torch.examples.distributed import mesh_shape

    assert mesh_shape(8) == (4, 2) and mesh_shape(4) == (2, 2) and mesh_shape(1) == (1, 1)
    assert mesh_shape(3) == (3, 1)
