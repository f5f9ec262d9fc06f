"""The upstream temperature model in float64 through the port's normal
path (``albatross_tpu_torch.temperature.build_model``,
``GaussianProcess.log_likelihood`` with autograd, ``fit`` and a marginal
predict) against the plain float64 reference
(``tests/reference_temperature.py``) on the CPU, at seeded random values
of the five parameters that the port leaves free.  The benchmark's copy
of the reference (``gpbench/reference/temperature_f64.py``) gives the
same numbers to the bit, and the same port run in float32 on the inputs
rounded to float32 fails the tolerances."""

import numpy as np
import pytest
import torch

import albatross_tpu_torch as pt
import reference_temperature as ref
from albatross_tpu_torch import temperature as ttemp
from gpbench import generator
from gpbench.reference import temperature_f64 as bench_ref

N = 384  # stations: every term of the covariance at a size the CPU factors in milliseconds
SEEDS = (1, 2, 3)

# Tolerances, each far above what float64 reads and far below what float32
# reads at N = 384 (seeds 1-3: float64 / float32):
# the NLML's relative error: 0 / at least 8.5e-4; f64's unit roundoff is
# 1.1e-16 and the sums over 384 rows may grow it a few hundred-fold
VALUE_TOL = 1e-12
# each gradient leaf's error over its own magnitude: at most 5e-13 / at
# least 1.2e-2; the sigma_constant leaf nets sums of about 1e3 into about
# 0.6, which costs three more digits
GRADIENT_TOL = 1e-9
# the predicted mean's and variance's largest error over the largest
# reference entry: at most 2.7e-14 / at least 1.2e-3; the posterior adds
# one solve with the factor to what the NLML does
PREDICT_TOL = 1e-11


def _case(seed: int):
    """(station rows, observations, {tunable name: value}): the stations by
    the port's own law, each tunable within 20% of upstream's value."""
    stations, obs, _ = ttemp.synthesize_stations(N, np.random.default_rng(seed))
    u = np.random.default_rng(seed + 1000).uniform(-1.0, 1.0, len(ref.TUNABLE))
    values = {name: ref.PARAMETERS[name] * (1.0 + 0.2 * du) for name, du in zip(ref.TUNABLE, u)}
    return stations, obs, values


def _port(seed: int, dtype: torch.dtype):
    """The port in ``dtype`` on the rows rounded to it: (NLML, its gradient
    by tunable name, predicted mean, predicted variance)."""
    stations, obs, values = _case(seed)
    model = ttemp.build_model()
    for name, value in values.items():
        model = model.set_param(name, value)
    data = pt.RegressionDataset.create(torch.as_tensor(stations, dtype=dtype), torch.as_tensor(obs, dtype=dtype),
                                       variance=torch.ones(N, dtype=dtype))
    tunable = model.get_tunable_parameters()
    assert list(tunable.names) == list(ref.TUNABLE)
    x = tunable.values.clone().requires_grad_(True)
    value = -model.set_tunable_params(x).log_likelihood(data)
    (grad,) = torch.autograd.grad(value, x)
    grid = torch.as_tensor(ttemp.sea_level_grid(8, 8), dtype=dtype)
    pred = model.fit(data).predict(grid).marginal()
    return value.item(), dict(zip(ref.TUNABLE, grad.tolist())), pred.mean.double(), pred.variance.double()


def _leaves(values: dict) -> dict:
    return {name: torch.tensor(v, dtype=torch.float64, requires_grad=True) for name, v in values.items()}


def _reference(seed: int):
    """The reference in float64 on the unrounded rows, as ``_port``."""
    stations, obs, values = _case(seed)
    x, y = torch.as_tensor(stations), torch.as_tensor(obs)
    leaves = _leaves(values)
    value = ref.nlml(x, y, {**ref.PARAMETERS, **leaves})
    grads = torch.autograd.grad(value, list(leaves.values()))
    post = ref.Posterior(x, y, torch.ones(N, dtype=torch.float64), {**ref.PARAMETERS, **values})
    mean, variance = post.marginal(torch.as_tensor(ttemp.sea_level_grid(8, 8)))
    return value.item(), {name: g.item() for name, g in zip(leaves, grads)}, mean, variance


def _errors(seed: int, dtype: torch.dtype) -> dict:
    value, grad, mean, variance = _port(seed, dtype)
    ref_value, ref_grad, ref_mean, ref_variance = _reference(seed)
    return {
        "value": abs(value - ref_value) / abs(ref_value),
        "gradient": max(abs(grad[k] - ref_grad[k]) / abs(ref_grad[k]) for k in ref.TUNABLE),
        "mean": ((mean - ref_mean).abs().max() / ref_mean.abs().max()).item(),
        "variance": ((variance - ref_variance).abs().max() / ref_variance.abs().max()).item(),
    }


TOLERANCES = {"value": VALUE_TOL, "gradient": GRADIENT_TOL, "mean": PREDICT_TOL, "variance": PREDICT_TOL}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", SEEDS)
def test_float64_port_matches_the_reference(seed):
    """NLML, the gradient of all five tunables, and fit + marginal predict
    with the targets' variance."""
    errors = _errors(seed, torch.float64)
    assert all(errors[k] <= tol for k, tol in TOLERANCES.items()), errors


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_port_fails_the_tolerances(seed):
    """The tolerances separate the precisions: the same port in float32 on
    the rows rounded to float32 exceeds at least one of them."""
    errors = _errors(seed, torch.float32)
    assert any(errors[k] > tol for k, tol in TOLERANCES.items()), errors


@pytest.mark.parametrize("seed", SEEDS)
def test_the_benchmarks_copy_of_the_reference_is_the_same_to_the_bit(seed):
    stations, obs, values = _case(seed)
    x, y = torch.as_tensor(stations), torch.as_tensor(obs)
    config = {"kernel": dict(ref.PARAMETERS), "jitter": 0.0}
    ours, theirs = _leaves(values), _leaves(values)
    value = ref.nlml(x, y, {**ref.PARAMETERS, **ours})
    data = generator.Training(x, y, torch.ones(N, dtype=torch.float64))
    bench_value = bench_ref.nlml(data, theirs, config)
    assert value.item() == bench_value.item()
    grads = torch.autograd.grad(value, list(ours.values()))
    bench_grads = torch.autograd.grad(bench_value, list(theirs.values()))
    assert [g.item() for g in grads] == [g.item() for g in bench_grads]
    grid = torch.as_tensor(ttemp.sea_level_grid(4, 4))
    ours = ref.Posterior(x, y, data.variance, dict(ref.PARAMETERS)).marginal(grid)
    theirs = bench_ref.Posterior(config, data).marginal(grid)
    assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
