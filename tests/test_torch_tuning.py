"""Port parity of the tunable-parameter round trip and the tuners.

The same numpy values go through the JAX package and the port, both in f64
on the CPU.  Tolerances, with their reasons:
- the round trip: 1e-15 relative (one log or exp of the same f64 value);
- Adam: the JAX tuner's history to 1e-8 relative over 20 steps (optax's
  and torch's Adam are the same arithmetic up to rounding order, and the
  objectives agree to ~1e-14);
- Nelder-Mead: 1e-12 (the same plain-numpy simplex on objectives that
  agree to ~1e-14);
- L-BFGS: the optimum, not the trajectory (optax's zoom line search and
  torch's strong-Wolfe one take other steps to the same point), within
  5e-3 of the known minimizer on the quadratic as the JAX test states, and
  within 1e-4 in the tunable vector and 1e-8 relative in the NLML of the
  JAX tuner's optimum on the NLML problem.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu.core.parameters import TunableParameters as JaxTunable
from albatross_tpu.core.parameters import get_tunable_parameters as jax_get_tunable
from albatross_tpu.core.parameters import set_tunable_params as jax_set_tunable
from albatross_tpu.evaluation import GaussianProcessNegativeLogLikelihood as JaxNLL
from albatross_tpu.tuning import GenericTuner as JaxGenericTuner
from albatross_tpu.tuning import get_tuner as jax_get_tuner
from albatross_tpu.tuning import greedy_tune as jax_greedy_tune
from albatross_tpu_torch.convert import tunable_to_numpy
from albatross_tpu_torch.core import (
    Parameter,
    TunableParameters,
    get_tunable_parameters,
    set_tunable_params,
)
from albatross_tpu_torch.evaluation import GaussianProcessNegativeLogLikelihood
from albatross_tpu_torch.tuning import (
    GenericTuner,
    compute_gradient,
    get_tuner,
    greedy_tune,
    tune_parameter_store,
)

torch.set_num_threads(2)


def _stores():
    """The same parameter store in both packages: log-scale, uniform,
    fixed, positive and uninformative priors."""
    spec = {
        "b_log": (10.0, "LogScaleUniformPrior", (1e-2, 1e4)),
        "a_plain": (3.0, "UniformPrior", (0.0, 5.0)),
        "c_fixed": (7.0, "FixedPrior", ()),
        "d_pos": (0.25, "PositivePrior", ()),
        "e_free": (-1.5, "UninformativePrior", ()),
    }
    jax_store = {k: ab.core.Parameter(v, getattr(ab.core, p)(*a)) for k, (v, p, a) in spec.items()}
    port_store = {k: Parameter(v, getattr(pt, p)(*a)) for k, (v, p, a) in spec.items()}
    return jax_store, port_store


def test_tunable_round_trip_matches_jax():
    jax_store, port_store = _stores()
    ref = jax_get_tunable(jax_store)
    names, values, lower, upper = tunable_to_numpy(get_tunable_parameters(port_store))
    assert names == ref.names == ["a_plain", "b_log", "d_pos", "e_free"]
    np.testing.assert_allclose(values, np.asarray(ref.values), rtol=1e-15)
    np.testing.assert_allclose(lower, np.asarray(ref.lower_bounds), rtol=1e-15)
    np.testing.assert_allclose(upper, np.asarray(ref.upper_bounds), rtol=1e-15)
    # back again, and from a vector that both clamp
    for x in (values, np.array([9.0, math.log(1e6), -1.0, 4.0])):
        want = jax_set_tunable(jax_store, jnp.asarray(x))
        got = set_tunable_params(port_store, x)
        assert sorted(got) == sorted(want)
        for name in want:
            assert float(got[name].value) == pytest.approx(float(want[name].value), rel=1e-15)
            assert got[name].prior.name == want[name].prior.name
    clamped = set_tunable_params(port_store, np.array([9.0, math.log(1e6), -1.0, 4.0]))
    assert float(clamped["a_plain"].value) == 5.0
    assert float(clamped["b_log"].value) == pytest.approx(1e4, rel=1e-15)
    assert float(clamped["d_pos"].value) == pytest.approx(2.220446049250313e-16)
    unclamped = set_tunable_params(port_store, np.array([9.0, 0.0, -1.0, 4.0]), force_bounds=False)
    assert float(unclamped["a_plain"].value) == 9.0 and float(unclamped["d_pos"].value) == -1.0


def test_tunable_errors():
    _, port_store = _stores()
    with pytest.raises(ValueError, match="expected 4 tunable values, got 3"):
        set_tunable_params(port_store, np.zeros(3))
    with pytest.raises(ValueError, match="expected 4 tunable values, got 5"):
        set_tunable_params(port_store, np.zeros(5))
    with pytest.raises(ValueError, match="INVALID PARAMETER: a expected to be greater than"):
        get_tunable_parameters({"a": Parameter(-1.0, pt.PositivePrior())})
    with pytest.raises(ValueError, match="INVALID PARAMETER: a expected to be less than"):
        get_tunable_parameters({"a": Parameter(2.0, pt.UniformPrior(0.0, 1.0))})


def test_grad_through_set_tunable_params():
    params = {"ls": Parameter(2.0, pt.LogScaleUniformPrior(1e-6, 1e6))}
    x = get_tunable_parameters(params).values.clone().requires_grad_(True)
    out = set_tunable_params(params, x)
    ((out["ls"].value - 3.0) ** 2).backward()
    # d/dlog(ls) (ls - 3)^2 = 2 (ls - 3) ls
    assert float(x.grad[0]) == pytest.approx(2 * (2.0 - 3.0) * 2.0, rel=1e-15)


def test_model_round_trip_methods():
    """The mixin's methods on a model: tunable vector, prior setters,
    set-if-exists, and a set_tunable_params that keeps x's graph."""
    model = pt.gp_from_covariance(pt.SquaredExponential(0.5, 1.0) + pt.IndependentNoise(0.3))
    model = model.set_param_prior("sigma_independent_noise", pt.FixedPrior())
    assert model.get_tunable_parameters().names == ["sigma_squared_exponential",
                                                    "squared_exponential_length_scale"]
    assert model.set_param_if_exists("no_such_param", 1.0) is model
    moved = model.set_param_values_if_exists({"squared_exponential_length_scale": 2.0, "nope": 1.0})
    assert moved.get_param_value("squared_exponential_length_scale") == 2.0
    x = torch.tensor([0.0, 1.0], dtype=torch.float64, requires_grad=True)
    tuned = model.set_tunable_params(x)
    assert tuned.get_param_value("sigma_independent_noise") == 0.3
    value = tuned.get_param_value("squared_exponential_length_scale")
    assert value.grad_fn is not None and float(value.detach()) == 1.0


# -- the 40-point problem of tests/test_tuning_samplers.py ----------------------
def _problem(n, seed=2012, ls=0.5, sigma=0.5):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 20.0, n))
    K = 1.5**2 * np.exp(-(((x[:, None] - x[None, :]) / 2.0) ** 2)) + 0.1**2 * np.eye(n)
    y = np.linalg.cholesky(K + 1e-12 * np.eye(n)) @ rng.standard_normal(n)

    def build(lib, data):
        kernel = lib.SquaredExponential(ls, sigma) + lib.measurement_only(lib.IndependentNoise(0.1))
        kernel = (kernel.set_param_prior("squared_exponential_length_scale", lib.LogScaleUniformPrior(1e-2, 1e3))
                  .set_param_prior("sigma_squared_exponential", lib.LogScaleUniformPrior(1e-2, 1e3))
                  .set_param_prior("sigma_independent_noise", lib.FixedPrior()))
        return lib.gp_from_covariance(kernel), data

    jax_side = build(ab, ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y)))
    port_side = build(pt, pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y)))
    return jax_side, port_side


def test_adam_history_matches_jax():
    (jm, jd), (tm, td) = _problem(40)
    ref = jax_get_tuner(jm, JaxNLL(), jd, optimizer="adam", max_iterations=20).tune()
    got = get_tuner(tm, GaussianProcessNegativeLogLikelihood(), td, optimizer="adam", max_iterations=20).tune()
    assert len(got.history) == len(ref.history) == 20
    np.testing.assert_allclose(got.history, ref.history, rtol=1e-8)
    np.testing.assert_allclose(got.x, np.asarray(ref.x), rtol=1e-8)
    assert got.value == pytest.approx(ref.value, rel=1e-8)
    assert float(got.params["sigma_independent_noise"].value) == 0.1


def test_lbfgs_reaches_the_jax_optimum_on_the_nlml():
    (jm, jd), (tm, td) = _problem(30, ls=0.7, sigma=0.7)
    ref = jax_get_tuner(jm, JaxNLL(), jd, optimizer="lbfgs", max_iterations=80).tune()
    logged = []
    tuner = get_tuner(tm, GaussianProcessNegativeLogLikelihood(), td, optimizer="lbfgs",
                      max_iterations=80, log_fn=lambda i, x, v: logged.append((i, v)))
    tuned_model, got = tuner.tuned_model()
    assert got.history[0] > got.value
    np.testing.assert_allclose(got.x, np.asarray(ref.x), rtol=0, atol=1e-4)
    assert got.value == pytest.approx(ref.value, rel=1e-8)
    assert [v for _, v in logged] == got.history and logged[0][0] == 0
    assert float(GaussianProcessNegativeLogLikelihood()(td, tuned_model)) == pytest.approx(got.value, rel=1e-12)


_QUAD_A = np.array([[4.5244, 1.43904, 2.24636], [1.43904, 2.26512, 0.985532], [2.24636, 0.985532, 2.18973]])
_QUAD_TRUTH = np.ones(3)
_QUAD_B = _QUAD_A @ _QUAD_TRUTH


def _quad_tunable(lib_tunable):
    return lib_tunable(names=["x_0", "x_1", "x_2"], values=np.zeros(3),
                       lower_bounds=np.full(3, -np.inf), upper_bounds=np.full(3, np.inf))


@pytest.mark.parametrize("optimizer", ["lbfgs", "nelder_mead"])
def test_quadratic_optimum_matches_jax(optimizer):
    """tests/test_reference_parity_r3.py::test_tune_quadratic_generic on the
    port: the vector form reaches the minimizer, as the JAX tuner does."""
    A, b = torch.tensor(_QUAD_A), torch.tensor(_QUAD_B)

    def objective(x):
        z = A @ x - b
        return z @ z

    ref = JaxGenericTuner(_quad_tunable(JaxTunable), optimizer=optimizer, max_iterations=300,
                          tolerance=1e-14).tune(lambda x: jnp.sum((jnp.asarray(_QUAD_A) @ x - _QUAD_B) ** 2))
    got = GenericTuner(_quad_tunable(TunableParameters), optimizer=optimizer, max_iterations=300,
                       tolerance=1e-14).tune(objective)
    assert np.abs(np.asarray(ref.x) - _QUAD_TRUTH).max() < 5e-3
    assert np.abs(got.x - _QUAD_TRUTH).max() < 5e-3
    if optimizer == "nelder_mead":  # the same plain-numpy simplex; values fall to ~1e-10
        np.testing.assert_allclose(got.history, ref.history, rtol=0, atol=1e-12 * ref.history[0])


def test_lbfgs_evaluates_each_point_once():
    """Each L-BFGS iteration starts at the point its line search accepted;
    the tuner hands back that trial's value and gradient instead of
    evaluating it again.  Only the final value, read at the last point,
    repeats one."""
    A, b = torch.tensor(_QUAD_A), torch.tensor(_QUAD_B)
    seen = []

    def objective(x):
        seen.append(x.detach().numpy().tobytes())
        z = A @ x - b
        return z @ z

    result = GenericTuner(_quad_tunable(TunableParameters), optimizer="lbfgs", max_iterations=8,
                          tolerance=0.0).tune(objective)
    assert len(result.history) == 8
    assert len(set(seen[:-1])) == len(seen) - 1 and seen[-1] in seen[:-1]


def test_tune_parameter_store_quadratic():
    A, b = torch.tensor(_QUAD_A), torch.tensor(_QUAD_B)
    params = {f"x_{i}": Parameter(0.0, pt.UninformativePrior()) for i in range(3)}

    def objective(store):
        z = A @ torch.stack([torch.as_tensor(store[f"x_{i}"].value) for i in range(3)]) - b
        return z @ z

    result = tune_parameter_store(objective, params, max_iterations=300, tolerance=1e-14)
    got = np.asarray([float(result.params[f"x_{i}"].value) for i in range(3)])
    assert np.abs(got - _QUAD_TRUTH).max() < 5e-3


def test_nelder_mead_history_matches_jax():
    (jm, jd), (tm, td) = _problem(25, ls=0.7, sigma=0.7)
    ref = jax_get_tuner(jm, JaxNLL(), jd, optimizer="nelder_mead", max_iterations=120).tune()
    got = get_tuner(tm, GaussianProcessNegativeLogLikelihood(), td, optimizer="nelder_mead",
                    max_iterations=120).tune()
    assert len(got.history) == len(ref.history)
    np.testing.assert_allclose(got.history, ref.history, rtol=1e-12)
    np.testing.assert_allclose(got.x, np.asarray(ref.x), rtol=1e-12)


def test_greedy_best_value_matches_jax():
    (jm, jd), (tm, td) = _problem(25, ls=0.2, sigma=0.3)
    _, ref = jax_greedy_tune(jm, lambda m: JaxNLL()(jd, m), n_candidates=7)
    best_model, got = greedy_tune(tm, lambda m: GaussianProcessNegativeLogLikelihood()(td, m), n_candidates=7)
    assert got == pytest.approx(ref, rel=1e-12)
    assert float(GaussianProcessNegativeLogLikelihood()(td, best_model)) == pytest.approx(got, rel=1e-12)


def test_finite_difference_matches_autograd():
    (_, _), (tm, td) = _problem(20, ls=1.0, sigma=1.0)
    tunable = tm.get_tunable_parameters()

    def objective(x):
        return GaussianProcessNegativeLogLikelihood()(td, tm.set_tunable_params(torch.as_tensor(x)))

    x0 = tunable.values.numpy()
    fd = compute_gradient(lambda x: float(objective(x)), x0, tunable.lower_bounds.numpy(),
                          tunable.upper_bounds.numpy())
    x = torch.tensor(x0, requires_grad=True)
    (exact,) = torch.autograd.grad(objective(x), x)
    np.testing.assert_allclose(fd, exact.numpy(), rtol=1e-4, atol=1e-5)
    # the step turns back at the upper bound
    g = compute_gradient(lambda x: float(x[0] ** 2), np.array([1.0]), [0.0], [1.0])
    assert g[0] == pytest.approx(2.0, rel=1e-6)


def test_tuner_bounds_without_clamp_fighting():
    """An optimum outside the box is approached smoothly through the bound
    bijection: no projected-step oscillation at the bound."""
    tunable = TunableParameters(names=["a", "b"], values=np.asarray([0.5, 0.5]),
                                lower_bounds=np.asarray([0.0, -np.inf]), upper_bounds=np.asarray([1.0, 2.0]))

    def objective(x):
        return (x[0] - 3.0) ** 2 + (x[1] + 1.0) ** 2

    result = GenericTuner(tunable, optimizer="adam", learning_rate=0.2, max_iterations=400).tune(objective)
    assert result.x[0] == pytest.approx(1.0, abs=1e-3)
    assert result.x[1] == pytest.approx(-1.0, abs=1e-3)
    assert 0.0 <= result.x[0] <= 1.0
    tail = result.history[-10:]
    assert max(tail) - min(tail) < 1e-3


def test_nan_objective_counts_as_inf_and_sync_every():
    """A NaN value is +inf to the tuner; history and log_fn see every step
    whatever the chunk size."""
    tunable = TunableParameters(names=["a"], values=np.asarray([0.5]), lower_bounds=np.asarray([-np.inf]),
                                upper_bounds=np.asarray([np.inf]))
    calls = []

    def objective(x):
        calls.append(1)
        return torch.where(x[0] > 0.4, x[0] * float("nan"), (x[0] - 0.1) ** 2)

    seen = []
    result = GenericTuner(tunable, optimizer="adam", learning_rate=0.05, max_iterations=7, sync_every=3,
                          log_fn=lambda i, x, v: seen.append(i)).tune(objective)
    assert result.history[0] == math.inf and seen == list(range(7)) and len(result.history) == 7
    with pytest.raises(ValueError, match="unknown optimizer"):
        GenericTuner(tunable, optimizer="sgd")
