"""Port parity for the whole slice: exact GP fit, predict and log-likelihood.

The JAX package's model and the port's are built from the same kernel
expression; the port's parameters are moved over by
``convert.params_from_numpy``.  The same numpy data go through both at f64.
Both factorize with the same algorithms (builtin Cholesky at n <= 2048, the
blocked column-panel loop above, with identity padding at n = 2113), so
results agree to 1e-9 relative: f64 rounding of O(n^3) work, amplified by
the condition number of K (~1e3 with noise 0.3^2 on sigma^2 = 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu_torch.convert import params_from_numpy

torch.set_num_threads(2)
RTOL = 1e-9


def _models(kind, jitter=1e-4):
    if kind == "bench":
        jk = ab.SquaredExponential(0.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True))
        tk = pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise(assume_unique=True))
    else:  # not the fused pattern: by-value noise (equality mask), Matern 5/2
        jk = ab.Matern52(2.0, 1.3) + ab.IndependentNoise(0.2)
        tk = pt.Matern52() + pt.IndependentNoise()
    jm = ab.gp_from_covariance(jk, jitter=jitter)
    tm = pt.gp_from_covariance(tk, jitter=jitter)
    tm = params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})
    return jm, tm


def _data(n, seed=0, variance=False):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    var = rng.uniform(0.01, 0.05, n) if variance else None
    jd = ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y), variance=var)
    td = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y), variance=var)
    return jd, td


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.max(np.abs(a - b)) <= RTOL * max(np.max(np.abs(b)), 1.0)


@pytest.mark.parametrize("n", [300, 2304, 2113])
def test_log_likelihood_matches_jax(n):
    jm, tm = _models("bench")
    jd, td = _data(n)
    ref = float(jm.log_likelihood(jd))
    got = tm.log_likelihood(td)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(ref, rel=RTOL)


def test_log_likelihood_unfused_kernel_matches_jax():
    jm, tm = _models("other")
    jd, td = _data(300, seed=1)
    assert float(tm.log_likelihood(td)) == pytest.approx(float(jm.log_likelihood(jd)), rel=RTOL)


@pytest.mark.parametrize("kind", ["bench", "other"])
@pytest.mark.parametrize("n", [300, 2304])
def test_predictions_match_jax(kind, n):
    jm, tm = _models(kind)
    jd, td = _data(n, seed=2, variance=True)
    xs = np.linspace(-5, 105, 77)
    jp = jm.fit(jd).predict(jnp.asarray(xs))
    tp = tm.fit(td).predict(torch.as_tensor(xs))
    _close(tp.mean(), jp.mean())
    jmarg, tmarg = jp.marginal(), tp.marginal()
    _close(tmarg.mean, jmarg.mean)
    _close(tmarg.variance, jmarg.variance)
    jjoint, tjoint = jp.joint(), tp.joint()
    _close(tjoint.mean, jjoint.mean)
    _close(tjoint.covariance, jjoint.covariance)


def test_marginal_clamps_only_rounding_negatives():
    """The predictive-variance clamp: rounding-scale negatives become 0,
    grossly negative values pass through so a failure surfaces."""
    from albatross_tpu_torch.models.gp import gp_marginal_prediction
    from albatross_tpu_torch.ops.linalg import ExplainedBySolve

    class Solve(ExplainedBySolve):
        def __init__(self, scale):
            self.scale = scale

        def solve(self, c):
            return self.scale * c

    cross = torch.ones((1, 2), dtype=torch.float64)
    prior = torch.tensor([1.0, 1.0], dtype=torch.float64)
    slight = gp_marginal_prediction(cross, prior, torch.ones(1, dtype=torch.float64), Solve(1.0 + 1e-6))
    assert torch.equal(slight.variance, torch.zeros(2, dtype=torch.float64))
    gross = gp_marginal_prediction(cross, prior, torch.ones(1, dtype=torch.float64), Solve(3.0))
    assert torch.all(gross.variance < -1.0)
