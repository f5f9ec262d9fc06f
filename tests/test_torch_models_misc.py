"""Port parity of the small models: null, least squares, linear regression,
conditional Gaussian and adapted models.

The same numpy inputs go through the JAX package's model and the port's at
f64 on the CPU: dense solves and least squares of full-rank systems of a
few rows, so results agree to 1e-9 relative to the largest entry (1e-8
for gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu.models import AdaptedModel as JAdaptedModel
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.core import Parameter, UniformPrior
from albatross_tpu_torch.models import AdaptedModel

torch.set_num_threads(2)
RTOL = 1e-9


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-300)


def _conditional_pair(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    cov = A @ A.T + n * np.eye(n)
    mean = rng.standard_normal(n)
    truth_mean, truth_var = mean + 0.5 * rng.standard_normal(n), 0.1 * np.ones(n)
    jm = ab.ConditionalGaussian(ab.JointDistribution.create(jnp.asarray(mean), jnp.asarray(cov)),
                                ab.MarginalDistribution.create(jnp.asarray(truth_mean), jnp.asarray(truth_var)))
    tm = pt.ConditionalGaussian(pt.JointDistribution.create(torch.as_tensor(mean), torch.as_tensor(cov)),
                                pt.MarginalDistribution.create(torch.as_tensor(truth_mean),
                                                               torch.as_tensor(truth_var)))
    return jm, tm, mean, cov, truth_mean


@pytest.mark.parametrize("n, train, test", [(8, [0, 2, 4, 6], [1, 3, 5, 7]), (12, [11, 3, 5], [0, 4, 10, 1, 2])])
def test_conditional_gaussian_matches_jax_and_manual(n, train, test):
    jm, tm, mean, cov, truth_mean = _conditional_pair(n, seed=n)
    jp, tp = jm.fit(np.asarray(train)).predict(np.asarray(test)), tm.fit(train).predict(test)
    _close(tp.mean(), jp.mean())
    _close(tp.marginal().variance, jp.marginal().variance)
    _close(tp.joint().covariance, jp.joint().covariance)
    train, test = np.asarray(train), np.asarray(test)
    Ktt = cov[np.ix_(train, train)] + 0.1 * np.eye(len(train))
    Kst = cov[np.ix_(train, test)]
    m_ref = mean[test] + Kst.T @ np.linalg.solve(Ktt, truth_mean[train] - mean[train])
    c_ref = cov[np.ix_(test, test)] - Kst.T @ np.linalg.solve(Ktt, Kst)
    _close(tp.joint().mean, m_ref)
    _close(tp.joint().covariance, c_ref, rtol=1e-8)
    _close(tm.get_prior(test).covariance, cov[np.ix_(test, test)], rtol=0)
    _close(tm.get_truth(train).mean, truth_mean[train], rtol=0)


def test_linear_regression_matches_jax():
    x = np.linspace(0, 10, 20)
    y = 3.0 + 2.0 * x + 0.01 * np.sin(7 * x)
    jfit = ab.LinearRegression().fit(ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y)))
    tfit = pt.LinearRegression().fit(pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y)))
    _close(tfit.fit.coefs, jfit.fit.coefs)
    xs = np.asarray([100.0, -3.0])
    _close(tfit.predict(torch.as_tensor(xs)).mean(), jfit.predict(jnp.asarray(xs)).mean())
    exact = pt.LinearRegression().fit(pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(3.0 + 2.0 * x)))
    _close(exact.fit.coefs, [3.0, 2.0])
    assert pt.LinearRegression().model_name == "linear_regression"


def test_least_squares_design_matrix_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((30, 3))
    y = A @ np.asarray([1.0, -2.0, 0.5]) + 0.01 * rng.standard_normal(30)
    jfit = ab.LeastSquares().fit(ab.RegressionDataset.create(jnp.asarray(A), jnp.asarray(y)))
    tfit = pt.LeastSquares().fit(pt.RegressionDataset.create(torch.as_tensor(A), torch.as_tensor(y)))
    _close(tfit.fit.coefs, jfit.fit.coefs)
    B = rng.standard_normal((4, 3))
    _close(tfit.predict(torch.as_tensor(B)).mean(), jfit.predict(jnp.asarray(B)).mean())
    assert pt.LeastSquares().model_name == "least_squares"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_null_model_matches_jax(dtype):
    data = pt.RegressionDataset.create(torch.tensor([1.0, 2.0], dtype=dtype), torch.tensor([3.0, 4.0], dtype=dtype))
    fit = pt.NullModel().fit(data)
    pred = fit.predict(torch.tensor([5.0, 6.0, 7.0], dtype=dtype))
    jpred = ab.NullModel().fit(ab.RegressionDataset.create(jnp.asarray([1.0, 2.0]), jnp.asarray([3.0, 4.0]))).predict(
        jnp.asarray([5.0, 6.0, 7.0]))
    assert pred.marginal().mean.dtype == dtype
    _close(pred.marginal().mean, jpred.marginal().mean, rtol=0)
    _close(pred.marginal().variance, jpred.marginal().variance, rtol=0)
    _close(pred.joint().covariance, jpred.joint().covariance, rtol=0)
    _close(pred.mean(), np.zeros(3), rtol=0)
    rebuilt = pt.NullModel().fit_from_prediction(torch.zeros(3), pred.joint())
    _close(rebuilt.predict(torch.zeros(2, dtype=dtype)).marginal().variance, [1e4, 1e4], rtol=0)
    assert pt.NullModel().model_name == "null_model"


def test_null_model_device_follows_the_features():
    """Integer features on the CPU keep the predictions there, in the default
    dtype; numpy features ask for the card, which raises
    without one rather than falling back to the CPU."""
    fit = pt.NullModel().fit(pt.RegressionDataset.create(torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])))
    pred = fit.predict(torch.arange(3))
    assert pred.marginal().mean.device.type == "cpu" and pred.joint().covariance.dtype == torch.get_default_dtype()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fit.predict(np.asarray([5.0, 6.0, 7.0])).marginal()


def _adapted_pair():
    jbase = ab.gp_from_covariance(ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.1)))
    tbase = params_from_numpy(pt.gp_from_covariance(pt.SquaredExponential() + pt.measurement_only(
        pt.IndependentNoise())), {k: np.asarray(p.value) for k, p in jbase.get_params().items()})
    jmodel = JAdaptedModel(jbase, lambda a, f: jnp.asarray(f) - a.center.value,
                           {"center": ab.core.Parameter(1.0, ab.UniformPrior(-10.0, 10.0))})
    tmodel = AdaptedModel(tbase, lambda a, f: f - a.center.value,
                          {"center": Parameter(1.0, UniformPrior(-10.0, 10.0))})
    return jmodel, tmodel, tbase


def test_adapted_model_matches_jax():
    """The adapter converts features with its own parameter before every
    fit, predict and log-likelihood; its parameter round-trips and takes
    gradients through the tunable vector like any other."""
    jmodel, tmodel, tbase = _adapted_pair()
    params = tmodel.get_params()
    assert "center" in params and "squared_exponential_length_scale" in params
    assert float(tmodel.set_param_value("center", 2.0).get_params()["center"].value) == 2.0
    assert tmodel.model_name == f"adapted[{tbase.model_name}]"
    x = np.linspace(0.0, 10.0, 15)
    y = np.sin(x)
    jd = ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y), variance=jnp.full((15,), 0.01))
    td = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y), variance=torch.full((15,), 0.01,
                                                                                                  dtype=torch.float64))
    xs = np.linspace(1.0, 9.0, 5)
    tp = tmodel.fit(td).predict(torch.as_tensor(xs))
    jp = jmodel.fit(jd).predict(jnp.asarray(xs))
    _close(tp.mean(), jp.mean())
    _close(tp.marginal().variance, jp.marginal().variance)
    _close(tp.joint().covariance, jp.joint().covariance)
    shifted = pt.RegressionDataset.create(torch.as_tensor(x - 1.0), torch.as_tensor(y), variance=td.targets.variance)
    _close(tp.marginal().mean, tbase.fit(shifted).predict(torch.as_tensor(xs - 1.0)).marginal().mean, rtol=1e-10)

    x0 = np.asarray(jmodel.get_tunable_parameters().values)
    assert jmodel.get_tunable_parameters().names == tmodel.get_tunable_parameters().names
    ref_v, ref_g = jax.value_and_grad(lambda v: -jmodel.set_tunable_params(v).log_likelihood(jd))(jnp.asarray(x0))
    xt = torch.tensor(x0, requires_grad=True)
    v = -tmodel.set_tunable_params(xt).log_likelihood(td)
    (g,) = torch.autograd.grad(v, xt)
    assert float(v.detach()) == pytest.approx(float(ref_v), rel=RTOL)
    _close(g, ref_g, rtol=1e-8)
