"""Port parity of the multivariate scores of evaluation/metrics.py.

The closed forms (variogram score, E|N|, the 2-Wasserstein distance) match
the JAX package to 1e-12 at f64.  The energy score is a Monte Carlo
estimate: fed the JAX package's normals it matches to 1e-12 (each normal's
sign follows its column of the square root, whose eigenvector signs LAPACK
may pick apart); from its own generator it lies within Monte Carlo error
of JAX's value, five standard deviations of the estimate measured over ten
seeds at the same sample count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albatross_tpu.core import JointDistribution as JJoint
from albatross_tpu.core import MarginalDistribution as JMarginal
from albatross_tpu.evaluation import metrics as jm
from albatross_tpu_torch.core import JointDistribution, MarginalDistribution
from albatross_tpu_torch.evaluation import metrics as tm

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))
TOL = 1e-12


def _problem(n=6, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    cov = A @ A.T / n + np.diag(np.linspace(0.1, 0.6, n))
    mean = rng.standard_normal(n)
    truth = mean + rng.standard_normal(n)
    var = rng.uniform(0.01, 0.1, n)
    return mean, cov, truth, var


def _both(mean, cov):
    return JJoint(jnp.asarray(mean), jnp.asarray(cov)), JointDistribution(torch.as_tensor(mean), torch.as_tensor(cov))


def _jax_normals(seed, n, num_samples):
    key_a, key_b = jax.random.split(jax.random.PRNGKey(seed))
    k = num_samples // 2 + 1
    return [np.asarray(jax.random.normal(key, (n, k), jnp.float64)) for key in (key_a, key_b)]


@pytest.mark.parametrize("truth_kind, weighted", [("vector", False), ("marginal", False), ("vector", True)])
def test_energy_score_given_the_same_normals(truth_kind, weighted):
    mean, cov, truth, var = _problem()
    jp, tp = _both(mean, cov)
    n = mean.shape[0]
    weights = np.linspace(0.5, 2.0, n) if weighted else None
    if truth_kind == "marginal":
        jt, tt = JMarginal(jnp.asarray(truth), jnp.asarray(var)), MarginalDistribution(
            torch.as_tensor(truth), torch.as_tensor(var))
        full = cov + np.diag(var)
    else:
        jt, tt, full = jnp.asarray(truth), torch.as_tensor(truth), cov
    ref = float(jm.energy_score(jp, jt, weights=None if weights is None else jnp.asarray(weights),
                                seed=22, num_samples=200))
    signs = np.sign(np.sum(np.asarray(jm._sampling_sqrt(jnp.asarray(full)))
                           * tm._sampling_sqrt(torch.as_tensor(full)).numpy(), axis=0))
    normals = [torch.as_tensor(z * signs[:, None]) for z in _jax_normals(22, n, 200)]
    got = float(tm.energy_score(tp, tt, weights=None if weights is None else torch.as_tensor(weights),
                                num_samples=200, normals=normals))
    assert got == pytest.approx(ref, rel=TOL)


def test_energy_score_within_monte_carlo_error_of_jax():
    mean, cov, truth, _ = _problem(8, 1)
    jp, tp = _both(mean, cov)
    ref = float(jm.energy_score(jp, jnp.asarray(truth), num_samples=1000))
    got = np.array([float(tm.energy_score(tp, torch.as_tensor(truth), seed=s, num_samples=1000))
                    for s in range(10)])
    assert abs(got.mean() - ref) <= 5.0 * got.std(ddof=1)
    assert abs(float(tm.energy_score(tp, torch.as_tensor(truth))) - ref) <= 5.0 * got.std(ddof=1)


def test_energy_score_guards():
    mean, cov, truth, _ = _problem()
    _, tp = _both(mean, cov)
    with pytest.raises(ValueError, match="1 or fewer"):
        tm.energy_score(tp, torch.as_tensor(truth), num_samples=1)
    with pytest.raises(ValueError, match="different sizes"):
        tm.energy_score(tp, torch.as_tensor(truth[:-1]))
    with pytest.raises(ValueError, match="weights"):
        tm.energy_score(tp, torch.as_tensor(truth), weights=torch.ones(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="positive definite"):
        tm._sampling_sqrt(torch.as_tensor(np.diag([1.0, -1.0, 2.0])))
    # a singular but semidefinite covariance samples
    S = tm._sampling_sqrt(torch.as_tensor(np.ones((3, 3))))
    np.testing.assert_allclose((S @ S.T).numpy(), np.ones((3, 3)), atol=1e-12)


@pytest.mark.parametrize("p", [1.0, 2.0])
@pytest.mark.parametrize("truth_kind, weighted", [("vector", False), ("marginal", True)])
def test_variogram_score_matches_jax(p, truth_kind, weighted):
    mean, cov, truth, var = _problem(7, 2)
    jp, tp = _both(mean, cov)
    weights = np.random.default_rng(3).uniform(0, 1, (7, 7)) if weighted else None
    if truth_kind == "marginal":
        jt, tt = JMarginal(jnp.asarray(truth), jnp.asarray(var)), MarginalDistribution(
            torch.as_tensor(truth), torch.as_tensor(var))
    else:
        jt, tt = jnp.asarray(truth), torch.as_tensor(truth)
    ref = float(jm.variogram_score(jp, jt, None if weights is None else jnp.asarray(weights), p=p))
    got = float(tm.variogram_score(tp, tt, None if weights is None else torch.as_tensor(weights), p=p))
    assert got == pytest.approx(ref, rel=TOL)


def test_variogram_score_guards():
    mean, cov, truth, _ = _problem()
    _, tp = _both(mean, cov)
    with pytest.raises(ValueError, match="p in"):
        tm.variogram_score(tp, torch.as_tensor(truth), p=3.0)
    with pytest.raises(ValueError, match="square matrix"):
        tm.variogram_score(tp, torch.as_tensor(truth), weights=torch.ones(6, dtype=torch.float64))
    with pytest.raises(ValueError, match="different sizes"):
        tm.variogram_score(tp, torch.as_tensor(truth[:3]))


def test_expected_abs_normal_matches_jax():
    mu = np.array([0.0, 1.5, -2.0, 0.3, np.nan, 1.0, 2.0])
    sigma = np.array([1.0, 0.5, 2.0, 0.0, 1.0, np.inf, -1.0])
    ref = np.asarray(jm.expected_abs_normal_1(jnp.asarray(mu), jnp.asarray(sigma)))
    got = tm.expected_abs_normal_1(torch.as_tensor(mu), torch.as_tensor(sigma)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[~np.isnan(ref)], ref[~np.isnan(ref)], rtol=TOL)
    assert float(tm.expected_abs_normal_1(0.5, 0.0)) == 0.5
    np.testing.assert_allclose(tm.expected_abs_normal_2(torch.as_tensor(mu), torch.as_tensor(sigma)).numpy(),
                               np.asarray(jm.expected_abs_normal_2(jnp.asarray(mu), jnp.asarray(sigma))),
                               rtol=TOL)


def test_wasserstein_2_matches_jax():
    mean_a, cov_a, _, _ = _problem(5, 4)
    mean_b, cov_b, _, _ = _problem(5, 5)
    ja, ta = _both(mean_a, cov_a)
    jb, tb = _both(mean_b, cov_b)
    ref = float(jm.wasserstein_2(ja, jb))
    assert float(tm.wasserstein_2(ta, tb)) == pytest.approx(ref, rel=1e-10)
    assert float(tm.wasserstein_2(ta, ta)) == pytest.approx(0.0, abs=1e-10)
    S = tm._principal_sqrt(torch.as_tensor(cov_a))
    np.testing.assert_allclose((S @ S).numpy(), cov_a, atol=1e-12)
