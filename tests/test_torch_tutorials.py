"""Port parity of the tutorials (``albatross_tpu_torch.tutorials``) against
the JAX package's ``tutorials/tutorial_*.py``, on the CPU in f64.

Each test runs the JAX tutorial's ``main()`` and the port's ``main`` with
``--device cpu`` and holds the printed text line by line
(tests/printed_numbers.py).  Numbers that are rounding residues (an update
against a refit, near 1e-15) are held below the tutorial's own bound on
both sides.  Tutorial 1's prior draws come from another random stream, so
the port's ``run()`` is handed the JAX key's normals and its draws held
at 1e-10; tutorial 2's gradient with respect to the parameter values is
held against ``jax.grad`` over the model at 1e-10.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from printed_numbers import assert_same_print

torch.set_num_threads(2)
torch.exp(torch.linspace(-3.0, 0.0, 4096, dtype=torch.float32))  # warm up the f32 exp
TUTORIALS = os.path.join(os.path.dirname(__file__), "..", "tutorials")
RTOL = 1e-10

# The line of each tutorial's text that holds rounding residues, and the
# bound the tutorial itself asserts on them.
NOISE = {
    "tutorial_3_sparse": {6: 1e-6},
    "tutorial_4_state_space": {0: 1e-8, 1: 1e-8},
}


def jax_tutorial(name: str):
    sys.path.insert(0, TUTORIALS)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(TUTORIALS)


def jax_text(name: str, capsys) -> str:
    assert jax_tutorial(name).main() in (0, None)
    return capsys.readouterr().out


def port_text(name: str, capsys) -> str:
    mod = importlib.import_module(f"albatross_tpu_torch.tutorials.{name}")
    assert mod.main(["--device", "cpu"]) == 0
    return capsys.readouterr().out


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
    assert err <= rtol, err


@pytest.mark.parametrize("name", ["tutorial_2_maximum_likelihood", "tutorial_3_sparse", "tutorial_4_state_space",
                                  "tutorial_5_evaluating_uncertainty"])
def test_tutorial_prints_what_jax_prints(name, capsys):
    assert_same_print(jax_text(name, capsys), port_text(name, capsys), noise=NOISE.get(name))


def test_tutorial_1_prints_what_jax_prints_but_the_draws(capsys):
    """Lines 1-3 are the prior draws, from another random stream (held in
    the next test)."""
    name = "tutorial_1_one_dimension"
    assert_same_print(jax_text(name, capsys), port_text(name, capsys), skip=(1, 2, 3))


def test_tutorial_1_draws_given_the_jax_normals():
    import albatross_tpu as ab
    from albatross_tpu.utils import sample_mvn

    from albatross_tpu_torch.tutorials import tutorial_1_one_dimension as pt1

    xs = jnp.linspace(0.0, 10.0, 101)
    model = ab.gp_from_covariance(
        ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.1)), jitter=1e-10)
    prior = model.prior(xs)
    key = jax.random.PRNGKey(1)
    normals = np.array(jax.random.normal(key, (101, 3), prior.mean.dtype))
    out = pt1.run("cpu", normals=normals)
    close(out["draws"], sample_mvn(key, prior, num_samples=3))
    pred = model.fit(ab.RegressionDataset.create(*_tutorial_1_data())).predict(xs).marginal()
    close(out["mean"], pred.mean)
    close(out["stddev"], jnp.sqrt(pred.variance))


def _tutorial_1_data():
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.sort(rng.uniform(0, 10, 12)))
    return x, jnp.sin(x) + 0.1 * jnp.asarray(rng.standard_normal(12))


def test_tutorial_2_gradient_is_jax_grad_over_the_model():
    """The port differentiates the parameter values (no pytree): the
    derivative of each tunable parameter's value equals ``jax.grad`` of
    the same metric over the JAX model."""
    import albatross_tpu as ab
    from albatross_tpu.core import FixedPrior, LogScaleUniformPrior
    from albatross_tpu.evaluation import GaussianProcessNegativeLogLikelihood

    from albatross_tpu_torch.tutorials import tutorial_2_maximum_likelihood as pt2

    rng = np.random.default_rng(4)
    n = 50
    x = np.sort(rng.uniform(0, 20, n))
    K = pt2.TRUTH_SIGMA**2 * np.exp(-(((x[:, None] - x[None, :]) / pt2.TRUTH_LENGTH_SCALE) ** 2))
    y = np.linalg.cholesky(K + pt2.NOISE**2 * np.eye(n)) @ rng.standard_normal(n)
    data = ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y))
    kernel = (ab.SquaredExponential(1.0, 1.0) + ab.measurement_only(ab.IndependentNoise(pt2.NOISE))).set_param_prior(
        "squared_exponential_length_scale", LogScaleUniformPrior(1e-2, 1e3)).set_param_prior(
        "sigma_squared_exponential", LogScaleUniformPrior(1e-2, 1e3)).set_param_prior(
        "sigma_independent_noise", FixedPrior())
    model = ab.gp_from_covariance(kernel)
    metric = GaussianProcessNegativeLogLikelihood()
    grads = jax.grad(lambda m: metric(data, m))(model).get_params()
    out = pt2.run("cpu")
    assert sorted(out["gradient"]) == ["sigma_squared_exponential", "squared_exponential_length_scale"]
    for name, g in out["gradient"].items():
        assert g == pytest.approx(float(grads[name].value), rel=RTOL), name
    assert out["nlml_before"] == pytest.approx(float(metric(data, model)), rel=RTOL)


def test_tutorial_4_runs_29_one_row_updates_to_the_batch_posterior():
    from albatross_tpu_torch.tutorials import tutorial_4_state_space as pt4

    out = pt4.run("cpu")
    assert out["mean_err"] < 1e-12 and out["var_err"] < 1e-12
    assert out["points"] == 21 and out["improved"] == 21


def test_every_jax_tutorial_has_a_port_counterpart():
    names = sorted(f[:-3] for f in os.listdir(TUTORIALS) if f.startswith("tutorial_") and f.endswith(".py"))
    assert len(names) == 5
    for name in names:
        mod = importlib.import_module(f"albatross_tpu_torch.tutorials.{name}")
        assert callable(mod.run) and callable(mod.main), name
