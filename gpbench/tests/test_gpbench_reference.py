"""The float64 reference against the port's plain CPU path in float64, at
small sizes: the same semantics, to rounding."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell

from gpbench import generator
from gpbench.program import Program
from gpbench.reference import common, exact, fitc


def f64_program(name):
    cell = tiny_cell(name)
    cell.config = dict(cell.config, dtype="float64")
    x, y = generator.training_data(cell.config, 11, "cpu")
    program = Program(cell, x, y)
    return cell, x, y, cell.kind.Loop(cell, program, 11)


@pytest.mark.parametrize("name", ["exact_se1d.tune", "fitc_se1d.tune", "exact_se1d.loo_tune"])
def test_objective_and_gradient(name):
    cell, x, y, loop = f64_program(name)
    objective = getattr(cell.reference, cell.traffic["objective"])
    for i in range(2):
        vector, value, grad = loop.step(loop.inputs(i))
        ref_value, ref_grad = common.value_grad(objective, cell.config, x, y, dict(zip(loop.names, vector.tolist())))
        assert value == pytest.approx(ref_value, rel=1e-10)
        np.testing.assert_allclose(grad, [ref_grad[n] for n in loop.names], rtol=1e-7,
                                   atol=1e-9 * np.max(np.abs(grad)))


def test_marginal_predictions():
    cell, x, y, loop = f64_program("exact_se1d.predict")
    posterior = cell.reference.Posterior(cell.config, x, y)
    xs = loop.inputs(0)
    got = loop.step(xs)
    mean, variance = posterior.marginal(xs)
    torch.testing.assert_close(got[0], mean, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(got[1], variance, rtol=1e-8, atol=1e-12)


def test_reference_fitc_nears_the_exact_gp_with_every_point_inducing():
    """FITC with the training inputs themselves as the inducing set and no
    nuggets is the exact GP: an independent check of the Woodbury form."""
    cell = tiny_cell("fitc_se1d.tune")
    config = dict(cell.config, inducing_points=40, dtype="float64", jitter=0.0)
    x = torch.linspace(0.0, 10.0, 40, dtype=torch.float64)
    y = torch.sin(x)
    params = {"length_scale": torch.tensor(0.5, dtype=torch.float64), "sigma": torch.tensor(1.0, dtype=torch.float64),
              "noise": torch.tensor(0.3, dtype=torch.float64), "measurement_nugget": torch.tensor(0.0, dtype=torch.float64),
              "inducing_nugget": torch.tensor(1e-12, dtype=torch.float64)}
    assert float(fitc.nlml(x, y, params, config)) == pytest.approx(float(exact.nlml(x, y, params, config)), rel=1e-6)


def test_leaf_gaps_hold_each_entry_to_its_own_scale():
    """A gradient entry a billionth of the largest is held to its own
    magnitude; one below the objective's float32 rounding to that."""
    from gpbench.kinds.tune import leaf_gaps

    ref = [1e-3, 4e5, 0.0]
    gaps = leaf_gaps([1.1e-3, 4e5, 1e-6], ref, ref_value=1e4)
    assert gaps[0] == pytest.approx(0.1)
    assert gaps[1] == 0.0
    assert gaps[2] == pytest.approx(1e-6 / (2.0**-24 * 1e4))
