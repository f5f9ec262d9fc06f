"""Port parity of the exact GP's serving side: update, for_serving,
fit_from_prediction and safe factorization.

The same numpy data go through the JAX package and the port at f64 on the
CPU, both run their library or blocked factorizations with the same
algorithms, so values agree to 1e-9 relative to the largest entry and
gradients to 1e-8.  Comparisons against a refit keep the JAX package's own
tolerances (tests/test_gp.py): an update and a refit factor different
matrices.  The update's kernel has no measurement-only term: the update
predicts the new block from unwrapped features, so only then does it equal
a refit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu.ops.linalg import CholeskyFactor as JCholeskyFactor
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.ops.block import BlockSymmetric
from albatross_tpu_torch.ops.linalg import CholeskyFactor, DirectInverse, ExplainedCovariance

torch.set_num_threads(2)
RTOL = 1e-9
GRAD_RTOL = 1e-8


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)
    assert err <= rtol, err


def _pair(jk, tk, **kwargs):
    jm = ab.gp_from_covariance(jk, **kwargs)
    tm = pt.gp_from_covariance(tk, **kwargs)
    return jm, params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})


def _plain_noise_models(jitter=0.0):
    """SE + plain IndependentNoise: no measurement-only term."""
    return _pair(ab.SquaredExponential(0.5, 1.0) + ab.IndependentNoise(0.3),
                 pt.SquaredExponential() + pt.IndependentNoise(), jitter=jitter)


def _bench_models(jitter=1e-4):
    return _pair(ab.SquaredExponential(0.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True)),
                 pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise(assume_unique=True)),
                 jitter=jitter)


def _data(n, seed, variance=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 100, n)
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    var = np.full(n, 0.01) if variance else None
    return x, y, var


def _datasets(x, y, var):
    jv = None if var is None else jnp.asarray(var)
    tv = None if var is None else torch.as_tensor(var)
    return (ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y), variance=jv),
            pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y), variance=tv))


# n = 300 + 100 factors with the library Cholesky; 2304 + 256 runs the
# blocked loop for the old block (2304) and the update's 2560 refit
@pytest.mark.parametrize("n_first, n_new", [(300, 100), (2304, 256)])
def test_update_matches_jax_and_a_refit(n_first, n_new):
    jm, tm = _plain_noise_models()
    x, y, var = _data(n_first + n_new, seed=n_first)
    jd, td = _datasets(x, y, var)
    first = np.arange(n_first)
    second = np.arange(n_first, n_first + n_new)
    j_up = jm.fit(jd[jnp.asarray(first)]).update(jd[jnp.asarray(second)])
    t_up = tm.fit(td[first]).update(td[second])
    assert isinstance(t_up.fit.train_covariance, BlockSymmetric)
    assert t_up.fit.train_features.shape == (n_first + n_new,)
    _close(t_up.fit.information, j_up.fit.information)

    xs = np.linspace(-1.0, 101.0, 60)
    jp, tp = j_up.predict(jnp.asarray(xs)).joint(), t_up.predict(torch.as_tensor(xs)).joint()
    _close(tp.mean, jp.mean)
    _close(tp.covariance, jp.covariance)
    _close(t_up.predict(torch.as_tensor(xs)).marginal().variance, j_up.predict(jnp.asarray(xs)).marginal().variance)

    direct = tm.fit(td).predict(torch.as_tensor(xs)).joint()  # the JAX tests' refit tolerances
    np.testing.assert_allclose(tp.mean.numpy(), direct.mean.numpy(), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(tp.covariance.numpy(), direct.covariance.numpy(), rtol=1e-5, atol=1e-9)
    assert t_up.for_serving() is t_up  # BlockSymmetric has no explicit-inverse form


def test_update_takes_a_dataset_or_a_mean_vector():
    _, tm = _plain_noise_models()
    x, y, var = _data(60, seed=1, variance=False)
    _, td = _datasets(x, y, var)
    fit = tm.fit(td[np.arange(40)])
    a = fit.update(td[np.arange(40, 60)]).predict(torch.linspace(0, 100, 7, dtype=torch.float64)).mean()
    b = fit.update(td.features[40:], td.targets.mean[40:]).predict(
        torch.linspace(0, 100, 7, dtype=torch.float64)).mean()
    assert torch.equal(a, b)


@pytest.mark.parametrize("refine_steps", [0, 2])
@pytest.mark.parametrize("n", [300, 2304])
def test_to_direct_inverse_matches_jax(n, refine_steps):
    """The explicit inverse with 0 and 2 Newton-Schulz steps against the JAX
    package's on the same training covariance, and its solves against the
    factor's."""
    jm, tm = _bench_models()
    x, y, var = _data(n, seed=n)
    jd, td = _datasets(x, y, var)
    jfit, tfit = jm.fit(jd).fit, tm.fit(td).fit
    _close(tfit.train_covariance.L, jfit.train_covariance.L)
    jinv = jfit.train_covariance.to_direct_inverse(refine_steps=refine_steps)
    tinv = tfit.train_covariance.to_direct_inverse(refine_steps=refine_steps)
    assert isinstance(tinv, DirectInverse)
    _close(tinv.inverse_matrix, jinv.inverse_matrix)
    rhs = np.random.default_rng(0).standard_normal((n, 3))
    _close(tinv.solve(torch.as_tensor(rhs)), tfit.train_covariance.solve(torch.as_tensor(rhs)), rtol=1e-8)


def test_to_direct_inverse_skips_a_step_outside_the_basin():
    """A starting inverse with max|I - A X| >= 1 is kept as it is: the gate
    stops the step that would diverge."""
    A = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    chol = CholeskyFactor.factorize(A)

    class Rough(CholeskyFactor):
        def inverse(self):
            return 3.0 * torch.linalg.inv(A)  # I - A X = -2 I

    X = Rough(chol.L).to_direct_inverse(refine_steps=2).inverse_matrix
    torch.testing.assert_close(X, 3.0 * torch.linalg.inv(A), rtol=1e-15, atol=0)


@pytest.mark.parametrize("n", [300, 2304])
def test_for_serving_predictions_unchanged(n):
    """for_serving swaps the factor for the explicit inverse; predictions
    stay those of the factor (the JAX test's tolerances) and equal the JAX
    package's serving predictions."""
    jm, tm = _bench_models()
    x, y, var = _data(n, seed=3 + n)
    jd, td = _datasets(x, y, var)
    xs = np.linspace(0.0, 100.0, 50)
    t_fit = tm.fit(td)
    serving = t_fit.for_serving()
    assert isinstance(serving.fit.train_covariance, DirectInverse)
    a, b = t_fit.predict(torch.as_tensor(xs)).marginal(), serving.predict(torch.as_tensor(xs)).marginal()
    np.testing.assert_allclose(b.mean.numpy(), a.mean.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(b.variance.numpy(), a.variance.numpy(), rtol=1e-7, atol=1e-12)
    j = jm.fit(jd).for_serving().predict(jnp.asarray(xs)).marginal()
    _close(b.mean, j.mean)
    _close(b.variance, j.variance, rtol=1e-8)


def test_fit_from_prediction_matches_jax():
    """C = K (K - P)^-1 K rebuilds the prediction: the round trip against
    the JAX package's, and against the prediction it came from (the JAX
    test's tolerances)."""
    jm, tm = _pair(ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2)),
                   pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise()))
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0.0, 10.0, 30))
    y = np.sin(x) + 0.1 * rng.standard_normal(30)
    jd, td = _datasets(x, y, np.full(30, 0.01))
    xs = np.linspace(1.0, 9.0, 6)
    jpred = jm.fit(jd).predict(jnp.asarray(xs)).joint()
    tpred = tm.fit(td).predict(torch.as_tensor(xs)).joint()
    txs = torch.as_tensor(xs)
    rebuilt = tm.fit_from_prediction(txs, tpred)
    assert isinstance(rebuilt.fit.train_covariance, ExplainedCovariance)
    jre = jm.fit_from_prediction(jnp.asarray(xs), jpred).predict(jnp.asarray(xs)).joint()
    tre = rebuilt.predict(txs).joint()
    _close(tre.mean, jre.mean)
    _close(tre.covariance, jre.covariance, rtol=1e-8)
    np.testing.assert_allclose(tre.mean.numpy(), tpred.mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tre.covariance.numpy(), tpred.covariance.numpy(), rtol=1e-4, atol=1e-8)
    _close(rebuilt.predict(txs).marginal().variance, jm.fit_from_prediction(jnp.asarray(xs), jpred).predict(
        jnp.asarray(xs)).marginal().variance, rtol=1e-8)
    with pytest.raises(NotImplementedError):
        pt.models.ModelBase().fit_from_prediction(txs, tpred)


def _jax_jitter(L, K):
    """The jitter the JAX package's factorize_safe added: L L^T - sym(K) is
    that multiple of I."""
    L, K = np.asarray(L, dtype=np.float64), np.asarray(K, dtype=np.float64)
    return float(np.mean(np.diagonal(L @ L.T - 0.5 * (K + K.T))))


def _duplicated_gram(n_distinct, dtype):
    x = np.repeat(np.linspace(0.0, 10.0, n_distinct), 2)
    return np.exp(-(((x[:, None] - x[None, :]) / 2.0) ** 2)).astype(dtype)


# (dtype, shift, initial jitter, expected): a gram of duplicated inputs is
# singular; shifting it by -shift I makes the first tries fail by a clear
# margin, so the choice does not hang on rounding
@pytest.mark.parametrize("dtype, shift, initial, expected", [
    (np.float64, 1e-9, 0.0, 2.220446049250313e-16 * 100**4),
    (np.float64, 1e-3, 0.0, 2.220446049250313e-16 * 100**5),  # no try factors: the last
    (np.float64, 0.0, 1e-6, 1e-6),
    (np.float64, -1.0, 0.0, 0.0),  # SPD: no jitter
    (np.float32, 1e-4, 0.0, 1.1920928955078125e-07 * 100**2),
    (np.float32, 1e-4, 1e-6, 1e-2),
])
def test_factorize_safe_chooses_the_jax_jitter(dtype, shift, initial, expected):
    K = _duplicated_gram(12, np.float64) - shift * np.eye(24)
    K = K.astype(dtype)
    jL = JCholeskyFactor.factorize_safe(jnp.asarray(K), initial_jitter=initial).L
    jitter = CholeskyFactor.safe_jitter(torch.as_tensor(K), initial_jitter=initial)
    tL = CholeskyFactor.factorize_safe(torch.as_tensor(K), initial_jitter=initial).L
    assert jitter == pytest.approx(expected, rel=1e-6)
    if shift == 1e-3:  # every try failed: NaN, as in the JAX package
        assert torch.isnan(tL.diagonal()).all() and np.isnan(np.diagonal(np.asarray(jL))).all()
        return
    assert jitter == pytest.approx(_jax_jitter(jL, K), rel=1e-3, abs=1e-12)
    _close(tL, jL, rtol=RTOL if dtype == np.float64 else 2e-5)


def _duplicated_dataset(n_distinct, seed):
    """Each input twice, with one target: the targets lie in the range of
    the singular gram, so the NLML stays well conditioned in them."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n_distinct))
    y = np.sin(x) + 0.1 * rng.standard_normal(n_distinct)
    return _datasets(np.repeat(x, 2), np.repeat(y, 2), None)


@pytest.mark.parametrize("jitter", [1e-8, 1e-6])
def test_safe_log_likelihood_and_gradient_match_jax(jitter):
    """The safe NLML (materialized covariance, factorize_safe) and its
    gradient with respect to the tunable vector against jax.value_and_grad,
    on duplicated inputs with no noise term (a singular gram) and the
    model's jitter as the initial jitter."""
    jm, tm = _pair(ab.SquaredExponential(0.5, 1.0), pt.SquaredExponential(), jitter=jitter,
                   safe_factorization=True)
    assert tm.safe_factorization
    jd, td = _duplicated_dataset(20, seed=5)
    x0 = np.asarray(jm.get_tunable_parameters().values)
    ref_v, ref_g = jax.value_and_grad(lambda x: -jm.set_tunable_params(x).log_likelihood(jd))(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    v = -tm.set_tunable_params(x).log_likelihood(td)
    (g,) = torch.autograd.grad(v, x)
    assert np.isfinite(float(ref_v))
    assert float(v.detach()) == pytest.approx(float(ref_v), rel=RTOL)
    _close(g, ref_g, rtol=GRAD_RTOL)
    xs = np.linspace(0.5, 9.5, 7)
    jp, tp = jm.fit(jd).predict(jnp.asarray(xs)).marginal(), tm.fit(td).predict(torch.as_tensor(xs)).marginal()
    _close(tp.mean, jp.mean, rtol=1e-8)
    assert torch.isfinite(tp.variance).all()


def test_safe_factorization_on_a_singular_gram_is_finite():
    """The JAX test's case: an exact duplicate, no noise.  The safe fit and
    NLML are finite; the blocked threshold is not involved."""
    x = torch.tensor([1.0, 1.0, 2.0, 3.0], dtype=torch.float64)
    data = pt.RegressionDataset.create(x, torch.tensor([0.5, 0.5, 1.0, -0.2], dtype=torch.float64))
    safe = pt.gp_from_covariance(pt.SquaredExponential(2.0, 1.0), safe_factorization=True)
    pred = safe.fit(data).predict(torch.tensor([1.5], dtype=torch.float64)).marginal()
    assert torch.isfinite(pred.mean).all() and torch.isfinite(pred.variance).all()
    assert torch.isfinite(safe.log_likelihood(data))


@pytest.mark.parametrize("kind", ["bench", "plain"])
def test_fit_predict_mean_gradient_matches_jax(kind):
    """The gradient of a weighted sum of fit -> predict means with respect
    to the tunable vector, by autograd through the port against jax.grad
    through the JAX package: the port's counterpart of differentiating the
    model pytree."""
    jm, tm = _bench_models() if kind == "bench" else _plain_noise_models(jitter=1e-8)
    x, y, var = _data(200, seed=9)
    jd, td = _datasets(x, y, var)
    xs = np.linspace(0.0, 100.0, 25)
    w = np.random.default_rng(1).standard_normal(25)
    x0 = np.asarray(jm.get_tunable_parameters().values)

    def jax_objective(v):
        return jnp.sum(jnp.asarray(w) * jm.set_tunable_params(v).fit(jd).predict(jnp.asarray(xs)).mean())

    ref_v, ref_g = jax.value_and_grad(jax_objective)(jnp.asarray(x0))
    xt = torch.tensor(x0, requires_grad=True)
    v = torch.sum(torch.as_tensor(w) * tm.set_tunable_params(xt).fit(td).predict(torch.as_tensor(xs)).mean())
    (g,) = torch.autograd.grad(v, xt)
    assert float(v) == pytest.approx(float(ref_v), rel=RTOL)
    _close(g, ref_g, rtol=GRAD_RTOL)


def test_predict_with_measurement_noise_adds_the_noise():
    jm, tm = _bench_models(jitter=0.0)
    x, y, var = _data(80, seed=2)
    jd, td = _datasets(x, y, var)
    xs = np.linspace(0.0, 100.0, 9)
    t_fit = tm.fit(td)
    noisy = t_fit.predict_with_measurement_noise(torch.as_tensor(xs)).marginal()
    plain = t_fit.predict(torch.as_tensor(xs)).marginal()
    _close(noisy.variance - plain.variance, np.full(9, 0.09), rtol=1e-12)
    _close(noisy.variance, jm.fit(jd).predict_with_measurement_noise(jnp.asarray(xs)).marginal().variance)


def test_gp_from_covariance_and_mean_and_negative_log_likelihood():
    from albatross_tpu_torch.models.gp import negative_log_likelihood

    model = pt.gp_from_covariance_and_mean(pt.SquaredExponential(1.0, 1.0), pt.ZeroMean(), model_name="m")
    assert model.model_name == "m" and isinstance(model.mean_function, pt.ZeroMean)
    rng = np.random.default_rng(0)
    G = rng.standard_normal((6, 6))
    K = G @ G.T + 6 * np.eye(6)
    d = rng.standard_normal(6)
    ref = 0.5 * (np.linalg.slogdet(K)[1] + d @ np.linalg.solve(K, d) + 6 * np.log(2 * np.pi))
    got = negative_log_likelihood(torch.as_tensor(d), CholeskyFactor.factorize(torch.as_tensor(K)))
    assert float(got) == pytest.approx(ref, rel=1e-12)
