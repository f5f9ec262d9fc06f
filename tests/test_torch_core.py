"""Port parity: core (priors, parameters, modules, distributions), the noise
and measurement kernels, and the compensated log-sum, against the JAX
package on the same numpy inputs (f64 unless stated)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu.core import priors as jpriors
from albatross_tpu.ops import compensated as jcomp
from albatross_tpu_torch.core import priors as tpriors
from albatross_tpu_torch.core.parameters import Parameter, map_join
from albatross_tpu_torch.ops import compensated as tcomp

torch.set_num_threads(2)

PRIORS = [
    ("UninformativePrior", ()),
    ("FixedPrior", ()),
    ("NonNegativePrior", ()),
    ("PositivePrior", ()),
    ("UniformPrior", (-1.0, 2.0)),
    ("LogScaleUniformPrior", (0.1, 10.0)),
    ("GaussianPrior", (0.5, 2.0)),
    ("LogNormalPrior", (0.2, 0.7)),
    ("PositiveGaussianPrior", (0.0, 3.0)),
]


@pytest.mark.parametrize("name,args", PRIORS)
def test_priors_match_jax(name, args):
    jp, tp = getattr(jpriors, name)(*args), getattr(tpriors, name)(*args)
    xs = np.array([-2.0, 0.0, 1e-3, 0.5, 1.5, 12.0])
    with np.errstate(all="ignore"):
        ref = np.asarray(jp.log_pdf(jnp.asarray(xs)))
    got = tp.log_pdf(torch.as_tensor(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, equal_nan=True)
    assert (tp.lower_bound, tp.upper_bound, tp.is_fixed, tp.is_log_scale, tp.name) == (
        jp.lower_bound, jp.upper_bound, jp.is_fixed, jp.is_log_scale, jp.name)
    assert len(tpriors.PRIOR_TYPES) == len(jpriors.PRIOR_TYPES) == 9


def test_parameters_and_modules():
    assert map_join({"a": Parameter(1.0)}, {"a": Parameter(2.0), "b": Parameter(3.0)}) == {
        "a": Parameter(1.0), "b": Parameter(3.0)}
    k = pt.SquaredExponential(1.0, 2.0) + pt.measurement_only(pt.IndependentNoise(0.5))
    jk = ab.SquaredExponential(1.0, 2.0) + ab.measurement_only(ab.IndependentNoise(0.5))
    assert sorted(k.get_params()) == sorted(jk.get_params())
    k2 = k.set_param_value("sigma_independent_noise", 0.7)
    assert k.get_param_value("sigma_independent_noise") == 0.5  # functional setter
    assert k2.get_param_value("sigma_independent_noise") == 0.7
    with pytest.raises(KeyError):
        k.set_param_value("nope", 1.0)
    model = pt.gp_from_covariance(k2)
    assert float(model.prior_log_likelihood()) == float(ab.gp_from_covariance(jk).prior_log_likelihood())


def test_distributions():
    m = pt.MarginalDistribution.create(torch.zeros(4, dtype=torch.float64), 0.5)
    assert torch.equal(m.variance, torch.full((4,), 0.5, dtype=torch.float64))
    assert torch.equal(pt.MarginalDistribution.create(torch.ones(3)).get_variance(), torch.zeros(3))
    j = pt.JointDistribution.create(torch.zeros(2), [[1.0, 0.2], [0.2, 2.0]])
    assert torch.equal(j.marginal().variance, torch.tensor([1.0, 2.0]))
    with pytest.raises(ValueError, match="disagree"):
        pt.RegressionDataset.create(np.zeros(3), np.zeros(4), device="cpu")


def test_noise_contract_matches_jax():
    """assume_unique: X is Y gives sigma^2 I even with duplicated features;
    without it, or across distinct batches, equality is by value."""
    x = np.array([0.0, 1.0, 1.0, 2.5])
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    for unique in (True, False):
        tn = pt.IndependentNoise(0.3, assume_unique=unique)
        jn = ab.IndependentNoise(0.3, assume_unique=unique)
        np.testing.assert_array_equal(tn(tx).numpy(), np.asarray(jn(jx)))
        np.testing.assert_array_equal(tn(tx, tx.clone()).numpy(), np.asarray(jn(jx, jnp.array(x))))
    meas = pt.measurement_only(pt.IndependentNoise(0.3))
    assert torch.equal(meas(tx), torch.zeros((4, 4), dtype=torch.float64))
    assert torch.equal(meas(pt.as_measurement(tx)).diagonal(), torch.full((4,), 0.09, dtype=torch.float64))
    assert torch.equal(meas.diag(tx), torch.zeros(4, dtype=torch.float64))


def test_error_free_transformations_match_jax():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        a = rng.standard_normal(1000).astype(dtype) * 1e3
        b = rng.standard_normal(1000).astype(dtype)
        for fn in ("two_sum", "two_prod"):
            th, tl = getattr(tcomp, fn)(torch.as_tensor(a), torch.as_tensor(b))
            jh, jl = getattr(jcomp, fn)(jnp.asarray(a), jnp.asarray(b))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            exact = (a.astype(np.float64) + b) if fn == "two_sum" else (a.astype(np.float64) * b)
            if dtype == np.float32:  # s + e (or p + e) is exact: check against f64
                np.testing.assert_array_equal(th.double().numpy() + tl.double().numpy(), exact)
        h, l = tcomp.dw_sum(torch.as_tensor(a))
        assert abs(float(h) + float(l) - math.fsum(a.astype(np.float64))) <= 1e-12 * np.sum(np.abs(a))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_accurate_sum_of_logs_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.05, 30.0, 5000).astype(dtype)
    got = float(tcomp.accurate_sum_of_logs(torch.as_tensor(x)))
    ref = float(jcomp.accurate_sum_of_logs(jnp.asarray(x)))
    exact = math.fsum(np.log(x.astype(np.float64)))
    # f32: each log is within about one f32 ulp and unbiased, the sum is
    # double-word, and the total is rounded once to f32 (6e-8); f64 logs
    # are the builtin's
    rel = 2e-7 if dtype == np.float32 else 1e-13
    assert got == pytest.approx(exact, rel=rel)
    assert got == pytest.approx(ref, rel=rel)
    x32 = x[:50].astype(np.float32)
    h, l = tcomp.accurate_log(torch.as_tensor(x32))
    jh, jl = jcomp.accurate_log(jnp.asarray(x32))
    np.testing.assert_allclose(h.double().numpy() + l.double().numpy(),
                               np.asarray(jh, np.float64) + np.asarray(jl, np.float64), rtol=0, atol=1e-7)
    np.testing.assert_allclose(h.double().numpy() + l.double().numpy(),
                               np.log(x32.astype(np.float64)), rtol=0, atol=2.5e-7)
    # invalid entries keep the builtin semantics: -inf and NaN surface
    assert float(tcomp.accurate_sum_of_logs(torch.tensor([1.0, 0.0], dtype=torch.from_numpy(x).dtype))) == -math.inf
    assert math.isnan(float(tcomp.accurate_sum_of_logs(torch.tensor([1.0, -1.0], dtype=torch.from_numpy(x).dtype))))


def test_concatenate_joints_matches_jax():
    rng = np.random.default_rng(4)
    parts = []
    for k in (2, 3, 1):
        A = rng.standard_normal((k, k))
        parts.append((rng.standard_normal(k), A @ A.T + np.eye(k)))
    ref = ab.core.concatenate_joints([ab.JointDistribution(jnp.asarray(m), jnp.asarray(c)) for m, c in parts])
    got = pt.core.concatenate_joints([pt.JointDistribution(torch.as_tensor(m), torch.as_tensor(c))
                                      for m, c in parts])
    assert got.covariance.dtype == torch.float64
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(ref.mean))
    np.testing.assert_array_equal(got.covariance.numpy(), np.asarray(ref.covariance))


def test_pretty_strings_match_jax():
    """The three pretty_* functions and the mixin's two methods give the
    JAX package's strings, for values held as floats and as tensors."""
    jk = ab.SquaredExponential(1.5, 1.2) + ab.IndependentNoise(0.25) + ab.Matern32(0.7, 0.3)
    jk = jk.set_param_prior("squared_exponential_length_scale", ab.core.LogScaleUniformPrior(1e-2, 1e2))
    jk = jk.set_param_prior("sigma_independent_noise", ab.core.GaussianPrior(0.2, 0.05))
    jk = jk.set_param_value("sigma_matern_32", 500.0)  # large, still valid
    jk = jk.set_param_prior("matern_32_length_scale", ab.core.UniformPrior(0.8, 3.0))  # 0.7: invalid
    tk = pt.SquaredExponential() + pt.IndependentNoise() + pt.Matern32()
    tk = tk.set_param_prior("squared_exponential_length_scale", pt.LogScaleUniformPrior(1e-2, 1e2))
    tk = tk.set_param_prior("sigma_independent_noise", pt.GaussianPrior(0.2, 0.05))
    tk = tk.set_param_prior("matern_32_length_scale", pt.UniformPrior(0.8, 3.0))
    values = {k: float(p.value) for k, p in jk.get_params().items()}
    tk = tk.set_param_values({k: (torch.tensor(v, dtype=torch.float64) if i % 2 else v)
                              for i, (k, v) in enumerate(sorted(values.items()))})
    jp, tp = jk.get_params(), tk.get_params()
    for name in ("pretty_params", "pretty_priors", "pretty_param_details"):
        assert getattr(pt.core, name)(tp) == getattr(ab.core, name)(jp), name
    assert tk.pretty_params() == jk.pretty_params()
    assert tk.pretty_param_details() == jk.pretty_param_details()
    assert "valid: False" in tk.pretty_param_details()
    assert pt.core.pretty_param_details({}) == ab.core.pretty_param_details({}) == ""


def test_core_exports_the_mixin_and_validity():
    assert pt.core.ParameterHandlingMixin is pt.core.parameters.ParameterHandlingMixin
    assert isinstance(pt.SquaredExponential(), pt.core.ParameterHandlingMixin)
    params = {"a": Parameter(0.5, tpriors.UniformPrior(0.0, 1.0))}
    assert pt.core.params_are_valid(params)
    assert not pt.core.params_are_valid({"a": Parameter(2.0, tpriors.UniformPrior(0.0, 1.0))})
