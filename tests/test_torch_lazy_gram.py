"""Port parity of the lazy-gram NLML (config.CHOLESKY_ALGORITHM = "right_fused").

The same numpy inputs go through the JAX package's ``right_fused``
log-likelihood (``jax.value_and_grad``, f64 on the CPU) and the port's
(autograd, f64 on the CPU, where the column producer takes the gram's closed
form).  n = 3072 divides the CPU block size of 1024; n = 2600 pads the
last panel, which the port does lazily and the JAX package by
materializing K.  The arithmetic is the same, so value and gradient agree
to f64 rounding of O(n^3) work amplified by the condition number: value
1e-10 relative, gradient rtol 1e-8 / atol 1e-10 per component (the
tolerances of the JAX package's own right_fused test).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu import config as jconfig
from albatross_tpu_torch import _build, config
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.ops.blocked_cholesky import blocked_cholesky_cols, blocked_cholesky_cols_fused
from albatross_tpu_torch.ops.linalg import CholeskyFactor
from albatross_tpu_torch.ops.radial_gram import fused_training_covariance, radial_gram_cols

tgp = importlib.import_module("albatross_tpu_torch.models.gp")
tbc = importlib.import_module("albatross_tpu_torch.ops.blocked_cholesky")
trg = importlib.import_module("albatross_tpu_torch.ops.radial_gram")

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))
VALUE_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-10, 1e-8, 1e-10
PARAMS = ("length scale", "sigma", "noise sigma")


def _models(kind, jitter=1e-4):
    if kind == "bench":
        jk = ab.SquaredExponential(0.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True))
        tk = pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise(assume_unique=True))
    elif kind == "matern":  # another profile through the lazy loop
        jk = ab.Matern52(2.0, 1.3) + ab.measurement_only(ab.IndependentNoise(0.2, assume_unique=True))
        tk = pt.Matern52() + pt.measurement_only(pt.IndependentNoise(assume_unique=True))
    else:  # noise by value (an equality mask): outside the fused pattern
        jk = ab.Matern52(2.0, 1.3) + ab.IndependentNoise(0.2)
        tk = pt.Matern52() + pt.IndependentNoise()
    jm = ab.gp_from_covariance(jk, jitter=jitter)
    tm = pt.gp_from_covariance(tk, jitter=jitter)
    return jm, params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})


def _inputs(n, d=1):
    rng = np.random.default_rng(n + d)
    x = np.sort(rng.uniform(0, 100, n)) if d == 1 else rng.uniform(0, 100, (n, d))
    y = np.sin(0.3 * (x if d == 1 else x[:, 0])) + 0.1 * rng.standard_normal(n)
    return x, y


def _port_value_grad(tm, x, y, algorithm):
    data = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y))
    prev = config.CHOLESKY_ALGORITHM
    config.CHOLESKY_ALGORITHM = algorithm
    try:
        xv = tm.get_tunable_parameters().values.clone().requires_grad_(True)
        value = -tm.set_tunable_params(xv).log_likelihood(data)
        (grad,) = torch.autograd.grad(value, xv)
    finally:
        config.CHOLESKY_ALGORITHM = prev
    return float(value.detach()), grad.numpy()


def _check(value, grad, ref_value, ref_grad):
    assert value == pytest.approx(ref_value, rel=VALUE_RTOL)
    for name, g, r in zip(PARAMS, grad, np.asarray(ref_grad)):  # each parameter apart
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("n", [3072, 2600])
@pytest.mark.parametrize("kind", ["bench", "matern", "other"])
def test_right_fused_value_grad_matches_jax(kind, n):
    """-log_likelihood and its gradient with respect to (length scale,
    sigma, noise sigma) through "right_fused" in both packages; the noise
    gradient sums over every panel's slice of the diagonal."""
    jm, tm = _models(kind)
    x, y = _inputs(n)
    jd = ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y))
    x0 = jm.get_tunable_parameters().values
    prev = jconfig.CHOLESKY_ALGORITHM
    jconfig.CHOLESKY_ALGORITHM = "right_fused"
    try:
        ref_value, ref_grad = jax.value_and_grad(lambda v: -jm.set_tunable_params(v).log_likelihood(jd))(x0)
    finally:
        jconfig.CHOLESKY_ALGORITHM = prev
    _check(*_port_value_grad(tm, x, y, "right_fused"), float(ref_value), ref_grad)


@pytest.mark.parametrize("n", [3072, 2600])
@pytest.mark.parametrize("kind", ["bench", "matern"])
def test_lazy_matches_the_materialized_path(kind, n):
    _, tm = _models(kind)
    x, y = _inputs(n)
    _check(*_port_value_grad(tm, x, y, "right_fused"), *_port_value_grad(tm, x, y, "right"))


@pytest.mark.parametrize("profile", ["squared_exponential", "matern_32"])
def test_column_blocks_equal_slices_of_the_training_covariance(profile):
    """Every panel of the column producer, the short last one included, is
    the matching block of the materialized covariance, bit for bit, its
    leading diagonal carrying the noise."""
    n, b = 2600, 1024
    x = torch.as_tensor(_inputs(n)[0])[:, None]
    kernel = pt.SquaredExponential(0.7, 1.3) if profile == "squared_exponential" else pt.Matern32(0.7, 1.3)
    kernel = kernel + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    K = fused_training_covariance(kernel, x, None, 1e-4)
    diag = torch.full((n,), 0.3 ** 2 + 1e-4, dtype=torch.float64)
    for j0 in range(0, n, b):
        bj = min(b, n - j0)
        col = radial_gram_cols(x, j0, bj, 0.7, 1.3, profile, diag)
        assert col.shape == (n - j0, bj)
        assert torch.equal(col, K[j0:, j0:j0 + bj])


@pytest.mark.parametrize("n", [3072, 2600, 900])
@pytest.mark.parametrize("assemble", [True, False])
def test_cols_fused_matches_cols_on_a_matrix(n, assemble):
    """blocked_cholesky_cols_fused over slices of K against
    blocked_cholesky_cols of K: divisible, padded and single-panel n."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    K = torch.as_tensor(A @ A.T / n + np.eye(n))
    y = torch.as_tensor(rng.standard_normal(n))

    def col_fn(j0, b):  # fresh panels: the loop updates them in place
        return K[j0:, j0:j0 + b].clone()

    got = blocked_cholesky_cols_fused(col_fn, n, rhs=y, block_size=1024, assemble=assemble)
    ref = blocked_cholesky_cols(K, block_size=1024, rhs=y, assemble=assemble)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)
    L = blocked_cholesky_cols_fused(col_fn, n, block_size=1024, device="cpu")
    torch.testing.assert_close(L, blocked_cholesky_cols(K, block_size=1024), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="requires rhs"):
        blocked_cholesky_cols_fused(col_fn, n, assemble=False, device="cpu")


def _spy(monkeypatch):
    calls = []
    real = tgp._fused_gram_nlml

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tgp, "_fused_gram_nlml", spy)
    return calls


def test_fused_min_n_auto_upgrade(monkeypatch):
    """The default "right" switches to the lazy loop from a (patched)
    CHOLESKY_FUSED_MIN_N on and not below it, never when the threshold is
    0 or for a kernel outside the fused pattern, at every D (the JAX
    package keeps D > 8 materialized; the port's column producer is the
    gram kernel there too); "left" raises.  The upgraded value equals the
    materialized one."""
    calls = _spy(monkeypatch)
    n = 3072
    _, tm = _models("bench")
    _, other = _models("other")
    x, y = _inputs(n)
    data = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y))
    monkeypatch.setattr(config, "CHOLESKY_ALGORITHM", "right")
    monkeypatch.setattr(config, "CHOLESKY_FUSED_MIN_N", 0)
    ll_ref = float(tm.log_likelihood(data))
    assert calls == []
    monkeypatch.setattr(config, "CHOLESKY_FUSED_MIN_N", n + 1)
    tm.log_likelihood(data)
    assert calls == []
    monkeypatch.setattr(config, "CHOLESKY_FUSED_MIN_N", n)
    assert float(tm.log_likelihood(data)) == pytest.approx(ll_ref, rel=VALUE_RTOL)
    assert calls == [(n, 1)]
    other.log_likelihood(data)
    assert calls == [(n, 1)]
    xd, yd = _inputs(n, d=9)
    tm.log_likelihood(pt.RegressionDataset.create(torch.as_tensor(xd), torch.as_tensor(yd)))
    assert calls == [(n, 1), (n, 9)]
    small_x, small_y = _inputs(2048)
    monkeypatch.setattr(config, "CHOLESKY_FUSED_MIN_N", 1024)
    tm.log_likelihood(pt.RegressionDataset.create(torch.as_tensor(small_x), torch.as_tensor(small_y)))
    assert calls == [(n, 1), (n, 9)]  # the pattern and n > 2048 are both required
    xd, yd = _inputs(n, d=8)
    tm.log_likelihood(pt.RegressionDataset.create(torch.as_tensor(xd), torch.as_tensor(yd)))
    assert calls == [(n, 1), (n, 9), (n, 8)]
    monkeypatch.setattr(config, "CHOLESKY_ALGORITHM", "left")
    with pytest.raises(ValueError, match="not ported"):
        tm.log_likelihood(data)
    with pytest.raises(ValueError, match="not ported"):
        CholeskyFactor.nlml_terms(None, data.targets.mean, col_fn=lambda j0, b: None)


def test_lazy_path_never_materializes(monkeypatch):
    """The lazy value+grad builds no covariance and no column copies: the
    materialized path's two producers raise if called."""

    def refuse(*args, **kwargs):
        raise AssertionError("the lazy path materialized the covariance")

    monkeypatch.setattr(tbc._ColumnPanels, "apply", refuse)
    monkeypatch.setattr(tgp, "fused_training_covariance", refuse)
    monkeypatch.setattr(trg, "fused_training_covariance", refuse)
    _, tm = _models("bench")
    x, y = _inputs(2600)
    _build.reset_launch_counts()
    value, grad = _port_value_grad(tm, x, y, "right_fused")
    assert np.isfinite(value) and np.isfinite(grad).all()
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: the closed form
    assert _build.BACKWARDS["panel_cholinv"] == 3


def test_nlml_terms_with_the_gp_column_producer():
    """CholeskyFactor.nlml_terms(col_fn=...) over the GP's own column
    producer gives the materialized covariance's terms."""
    _, tm = _models("bench")
    x, y = _inputs(2600)
    xt = torch.as_tensor(x)
    col_fn = tm._training_cov_col_fn(pt.as_measurement(xt))
    # D > 8 too: the port's column producer is the gram kernel at every D
    x9 = torch.as_tensor(np.random.default_rng(9).uniform(0, 10, (300, 9)))
    col9 = tm._training_cov_col_fn(pt.as_measurement(x9))(128, 128)
    K9 = fused_training_covariance(tm.covariance_function, x9, None, tm.jitter)
    assert torch.equal(col9, K9[128:, 128:256])
    got = CholeskyFactor.nlml_terms(None, torch.as_tensor(y), col_fn=col_fn)
    K = fused_training_covariance(tm.covariance_function, xt[:, None], None, tm.jitter)
    ref = CholeskyFactor.nlml_terms(K, torch.as_tensor(y), assume_symmetric=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)
